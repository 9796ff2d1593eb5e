from stereo_vo_tpu_torch.engine.driver import VORun, run_vo
from stereo_vo_tpu_torch.engine.step import StepOutput, VOEngine, VOState

__all__ = ["VOEngine", "VOState", "StepOutput", "run_vo", "VORun"]
