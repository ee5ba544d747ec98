"""Hardware configuration constants (reference real_world/setup.py:7-52).

Edit these for your rig; they are intentionally plain module constants, the
way the reference keeps them."""

import numpy as np

# robot endpoints
LEFT_UR5_IP = "192.168.0.100"
RIGHT_UR5_IP = "192.168.0.101"
UR5_PORT = 30002  # URScript command port
UR5_RTC_PORT = 30003  # real-time state stream

# gripper endpoints
WSG50_IP = "192.168.0.110"
WSG50_PORT = 1000
# RG2 is driven through UR digital IO — no address

# cameras
KINECT_RPC_URL = "http://192.168.0.120:8080"
REALSENSE_IP = "192.168.0.121"
REALSENSE_PORT = 50000

# workspace geometry
DIST_UR5 = 1.34  # meters between arm bases
LEFT_ARM_BASE = np.array([DIST_UR5 / 2, 0.0, 0.0])
RIGHT_ARM_BASE = np.array([-DIST_UR5 / 2, 0.0, 0.0])
REACH_LIMIT = 0.9

# top-down workspace crop of the kinect frame (row0, row1, col0, col1)
WS_PC = (160, 864, 448, 1152)

# grasp width bounds in meters (stretch safety, reference setup.py)
MIN_GRASP_WIDTH = 0.15
MAX_GRASP_WIDTH = 0.80

# observation / control rates
CONTROL_HZ = 125.0

CLOTHS = {
    "white_rect": {"flattened_area": 0.25, "mass_kg": 0.405},
    "large_rect": {"flattened_area": 0.42, "mass_kg": 0.650},
    "shirt": {"flattened_area": 0.21, "mass_kg": 0.220},
}
