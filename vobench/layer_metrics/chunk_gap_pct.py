"""Driver and host path: 100 times the share of the window outside the
chunks' CUDA-event spans (uploads, bootstraps, fetches, the host between
chunks), %."""


def read(window):
    spans = [c.device_ms for c in window.chunks if c.device_ms is not None]
    if not spans or window.seconds <= 0:
        return None
    return float(100.0 * (1.0 - sum(spans) / 1000.0 / window.seconds))
