"""Chunk program on the device: the CUDA-event spans bracketing each
``replay_chunk`` call, summed, over the frames of those chunks, ms. Sound
while the host enqueues a chunk's launches ahead of the device, which the
run prints (the closing event still pending as the call returns)."""


def read(window):
    spans = [c for c in window.chunks if c.device_ms is not None]
    frames = sum(c.frames for c in spans)
    return float(sum(c.device_ms for c in spans) / frames) if frames else None
