"""Gripper drivers: Schunk WSG50 (text protocol over TCP) and OnRobot RG2
(driven through UR digital IO) — reference real_world/wsg50.py, rg2.py."""

from __future__ import annotations

import abc
import socket
import time
from typing import Optional


class Gripper(abc.ABC):
    """Reference Gripper ABC (realur5.py:9-31)."""

    @abc.abstractmethod
    def open(self):
        ...

    @abc.abstractmethod
    def close(self):
        ...

    @property
    @abc.abstractmethod
    def width(self) -> float:
        ...


class WSG50(Gripper):
    """Schunk WSG50 over its scripting TCP interface (port 1000)."""

    MAX_WIDTH_MM = 110.0

    def __init__(self, ip: str, port: int = 1000):
        self.ip = ip
        self.port = port
        self._sock: Optional[socket.socket] = None

    def connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.ip, self.port), timeout=5)
            self._cmd("FSACK()")  # clear fast-stop on connect

    def _cmd(self, text: str) -> str:
        self.connect()
        self._sock.sendall((text + "\n").encode())
        return self._sock.recv(1024).decode(errors="replace")

    def open(self, width_mm: float = MAX_WIDTH_MM, speed_mms: float = 420.0):
        self._cmd(f"MOVE({width_mm:.1f}, {speed_mms:.1f})")

    def close(self, speed_mms: float = 420.0, force_n: float = 80.0):
        self._cmd(f"FORCE({force_n:.1f})")
        self._cmd(f"GRIP({force_n:.1f}, 0.0)")

    def release(self):
        self._cmd("RELEASE(105.0, 420.0)")

    @property
    def width(self) -> float:
        resp = self._cmd("POS?")
        try:
            return float(resp.strip().split("=")[-1]) / 1000.0
        except ValueError:
            return float("nan")


class RG2(Gripper):
    """OnRobot RG2 through the host UR5's IO: digital out toggles
    open/close, analog in reads the width (reference rg2.py)."""

    def __init__(self, ur5, digital_out: int = 8, analog_in: int = 0,
                 settle_s: float = 0.7):
        self.ur5 = ur5
        self.digital_out = digital_out
        self.analog_in = analog_in
        self.settle_s = settle_s
        self._width = 0.11

    def open(self):
        self.ur5.send_program(
            f"set_digital_out({self.digital_out}, False)")
        time.sleep(self.settle_s)
        self._width = 0.11

    def close(self):
        self.ur5.send_program(
            f"set_digital_out({self.digital_out}, True)")
        time.sleep(self.settle_s)
        self._width = 0.0

    @property
    def width(self) -> float:
        # analog width readback requires the RTC extended packet; fall back
        # to the last commanded state
        return self._width
