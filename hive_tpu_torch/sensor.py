"""Camera parameter presets for common sensors. (ref hive/sensor.py:21-27)"""

from hive_tpu_torch.geometric import CameraMatrix


class KinectSensor:
    """The Kinect RGB-D sensor used in the NYU v2 and TUM RGB-D datasets."""

    @staticmethod
    def get_camera_matrix() -> CameraMatrix:
        return CameraMatrix(fx=580.0, fy=580.0, cx=319.5, cy=239.5, width=640, height=480)
