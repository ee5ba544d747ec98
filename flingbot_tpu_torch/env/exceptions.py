"""Environment exceptions — API parity with environment/exceptions.py
(counterpart of flingbot_tpu/env/exceptions.py).

In the batched env these conditions become flags instead of raises (a
primitive that exceeds its servo budget truncates and sets timed_out), but
host-side code and the real_world stack keep the exception types."""


class MoveJointsException(Exception):
    """Cartesian servo failed to reach the target within the step limit
    (reference simEnv.py:769)."""


class MoveJointsOutOfTimeException(MoveJointsException):
    pass


class GraspFailException(Exception):
    """Real-world grasp failure (reference realWorldEnv.py)."""


class UR5MoveTimeoutException(Exception):
    """Real-world arm move timed out."""
