from stereo_vo_tpu_torch.data.kitti import KittiSequence, kitti_replay
from stereo_vo_tpu_torch.data.stream import LiveStereoStream, StereoFrame, StereoStream
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence

__all__ = [
    "KittiSequence",
    "kitti_replay",
    "LiveStereoStream",
    "SyntheticStereoSequence",
    "StereoFrame",
    "StereoStream",
]
