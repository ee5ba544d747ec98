"""UR5 driver over raw TCP: URScript commands + the 30003 real-time state
stream (reference real_world/realur5.py + realur5_utils.py).

The command port accepts URScript programs as text; the RTC port streams
binary state packets at 125 Hz (int32 length header followed by big-endian
doubles: joints at offset 252, TCP pose at 444 in the CB3 1116-byte
layout).  A daemon thread keeps the latest state; blocking moves poll it
until the target is reached or a timeout trips."""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional, Sequence

import numpy as np

from flingbot_tpu_torch.env.exceptions import UR5MoveTimeoutException

RTC_PACKET_SIZE = 1116
_JOINT_OFFSET = 252  # actual joint positions (6 doubles)
_TCP_OFFSET = 444  # actual TCP pose (6 doubles: x y z rx ry rz)


class UR5State:
    """Background reader of the real-time state stream."""

    def __init__(self, ip: str, port: int = 30003):
        self.ip = ip
        self.port = port
        self._lock = threading.Lock()
        self._joints: Optional[np.ndarray] = None
        self._tcp_pose: Optional[np.ndarray] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False

    def _loop(self):
        sock = socket.create_connection((self.ip, self.port), timeout=5)
        buf = b""
        try:
            while self._running:
                data = sock.recv(4096)
                if not data:
                    break
                buf += data
                while len(buf) >= 4:
                    (size,) = struct.unpack(">i", buf[:4])
                    if len(buf) < size:
                        break
                    packet, buf = buf[:size], buf[size:]
                    if size >= RTC_PACKET_SIZE:
                        self._parse(packet)
        finally:
            sock.close()

    def _parse(self, packet: bytes):
        joints = np.array(struct.unpack(
            ">6d", packet[_JOINT_OFFSET:_JOINT_OFFSET + 48]))
        tcp = np.array(struct.unpack(
            ">6d", packet[_TCP_OFFSET:_TCP_OFFSET + 48]))
        with self._lock:
            self._joints = joints
            self._tcp_pose = tcp

    @property
    def joints(self) -> Optional[np.ndarray]:
        with self._lock:
            return None if self._joints is None else self._joints.copy()

    @property
    def tcp_pose(self) -> Optional[np.ndarray]:
        with self._lock:
            return None if self._tcp_pose is None else self._tcp_pose.copy()


class UR5:
    """Synthesizes URScript movej/movel programs and blocks on the state
    stream until the target pose is reached (reference realur5.py:159-215)."""

    def __init__(self, ip: str, command_port: int = 30002,
                 rtc_port: int = 30003, joint_tolerance: float = 1e-2,
                 pose_tolerance: float = 5e-3):
        self.ip = ip
        self.command_port = command_port
        self.joint_tolerance = joint_tolerance
        self.pose_tolerance = pose_tolerance
        self._sock: Optional[socket.socket] = None
        self.state = UR5State(ip, rtc_port)

    # -- transport ------------------------------------------------------

    def connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.ip, self.command_port), timeout=5)
            self.state.start()

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        self.state.stop()

    def send_program(self, program: str):
        self.connect()
        if not program.endswith("\n"):
            program += "\n"
        self._sock.sendall(program.encode())

    # -- motion ---------------------------------------------------------

    def movej(self, joints: Sequence[float], a=1.4, v=1.05, blocking=True,
              timeout=15.0):
        js = ", ".join(f"{j:.6f}" for j in joints)
        self.send_program(f"movej([{js}], a={a}, v={v})")
        if blocking:
            self._wait_joints(np.asarray(joints, float), timeout)

    def movel(self, pose: Sequence[float], a=1.2, v=0.25, blocking=True,
              timeout=15.0):
        ps = ", ".join(f"{p:.6f}" for p in pose)
        self.send_program(f"movel(p[{ps}], a={a}, v={v})")
        if blocking:
            self._wait_pose(np.asarray(pose, float), timeout)

    def movel_waypoints(self, poses, a=1.2, v=0.25, blend=0.01,
                        blocking=True, timeout=30.0):
        """Blended multi-waypoint linear move — the fling trajectory shape
        (reference fling.py)."""
        lines = ["def wp():"]
        for i, pose in enumerate(poses):
            ps = ", ".join(f"{p:.6f}" for p in pose)
            r = 0.0 if i == len(poses) - 1 else blend
            lines.append(f"  movel(p[{ps}], a={a}, v={v}, r={r})")
        lines.append("end")
        self.send_program("\n".join(lines))
        if blocking:
            self._wait_pose(np.asarray(poses[-1], float), timeout)

    def speed_stop(self):
        self.send_program("stopl(5.0)")

    # -- blocking helpers ----------------------------------------------

    def _wait_joints(self, target, timeout):
        deadline = time.time() + timeout
        while time.time() < deadline:
            j = self.state.joints
            if j is not None and np.abs(j - target).max() \
                    < self.joint_tolerance:
                return
            time.sleep(0.004)
        raise UR5MoveTimeoutException(f"{self.ip} movej timeout")

    def _wait_pose(self, target, timeout):
        deadline = time.time() + timeout
        while time.time() < deadline:
            p = self.state.tcp_pose
            if p is not None and np.linalg.norm(p[:3] - target[:3]) \
                    < self.pose_tolerance:
                return
            time.sleep(0.004)
        raise UR5MoveTimeoutException(f"{self.ip} movel timeout")
