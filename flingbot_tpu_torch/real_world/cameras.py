"""Camera clients: Azure Kinect via an HTTP+pickle RPC sidecar, RealSense
via a raw TCP frame stream with a background capture thread
(reference real_world/kinect.py, realsense.py)."""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Optional, Tuple

import numpy as np


class KinectClient:
    """Talks to a kinect RPC server exposing /intr and /pickle endpoints."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")

    def _get(self, path: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(self.url + path, timeout=10) as resp:
            return resp.read()

    def get_intrinsics(self) -> np.ndarray:
        return pickle.loads(self._get("/intr"))

    def get_rgbd(self, repeats: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (color (H,W,3) uint8, depth (H,W) float meters); averages
        `repeats` depth frames to denoise."""
        colors, depths = [], []
        for _ in range(repeats):
            data = pickle.loads(self._get("/pickle"))
            colors.append(np.asarray(data["color_img"]))
            depths.append(np.asarray(data["depth_img"], np.float32))
        return colors[-1], np.mean(depths, axis=0)


class RealSense:
    """Binary TCP frame stream: each frame is an int64 length header then a
    pickled (color, depth) tuple; a daemon thread keeps the latest frame."""

    def __init__(self, ip: str, port: int, background_capture: bool = True):
        self.ip = ip
        self.port = port
        self._lock = threading.Lock()
        self._latest: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._running = False
        if background_capture:
            self.start()

    def start(self):
        if self._running:
            return
        self._running = True
        threading.Thread(target=self._loop, daemon=True).start()

    def stop(self):
        self._running = False

    def _recv_exact(self, sock, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("realsense stream closed")
            buf += chunk
        return buf

    def _loop(self):
        sock = socket.create_connection((self.ip, self.port), timeout=10)
        try:
            while self._running:
                (size,) = struct.unpack(">q", self._recv_exact(sock, 8))
                payload = self._recv_exact(sock, size)
                frame = pickle.loads(payload)
                with self._lock:
                    self._latest = frame
        finally:
            sock.close()

    def get_rgbd(self) -> Tuple[np.ndarray, np.ndarray]:
        import time

        for _ in range(500):
            with self._lock:
                if self._latest is not None:
                    return self._latest
            time.sleep(0.01)
        raise TimeoutError("no realsense frame received")
