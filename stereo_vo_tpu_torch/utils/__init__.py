from stereo_vo_tpu_torch.utils.profiling import Recorder, Trace, device_trace, summarize_trace

__all__ = ["Recorder", "Trace", "device_trace", "summarize_trace"]
