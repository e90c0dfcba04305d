from .robot import RobotBall  # noqa: F401
from .dh_robot import (  # noqa: F401
    DHRobot,
    IIWA14,
    SCARA,
    UR10E,
    UR5E,
    ik_checked,
)
