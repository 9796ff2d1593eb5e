from stereo_vo_tpu_torch.data.stream import StereoFrame, StereoStream
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence

__all__ = ["SyntheticStereoSequence", "StereoFrame", "StereoStream"]
