from .robot import RobotBall  # noqa: F401
