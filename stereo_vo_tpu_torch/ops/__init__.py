from stereo_vo_tpu_torch.ops.lk import lk_track_fwdbwd, lk_track_pyramid
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid, pyr_down
from stereo_vo_tpu_torch.ops.regions import extract_regions, extract_regions_ref
from stereo_vo_tpu_torch.ops.shi_tomasi import detect_corners, min_eig_response
from stereo_vo_tpu_torch.ops.stereo_bm import stereo_bm_at, stereo_bm_disparity

__all__ = [
    "lk_track_fwdbwd",
    "lk_track_pyramid",
    "build_pyramid",
    "pyr_down",
    "extract_regions",
    "extract_regions_ref",
    "detect_corners",
    "min_eig_response",
    "stereo_bm_at",
    "stereo_bm_disparity",
]
