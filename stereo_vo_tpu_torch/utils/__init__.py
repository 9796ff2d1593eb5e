from stereo_vo_tpu_torch.utils.profiling import StageTimer, device_trace, summarize_trace

__all__ = ["StageTimer", "device_trace", "summarize_trace"]
