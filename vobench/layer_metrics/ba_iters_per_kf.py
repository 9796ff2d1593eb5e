"""Bundle adjustment: the summaries' ``ba_iterations`` summed over the
window's keyframe steps, over the number of those keyframes (a count made
on the device; bootstraps, which run no BA, left out)."""


def read(window):
    kf = [s.summary for s in window.steps if s.kind == "step" and s.summary[7]]
    return float(sum(r[17] for r in kf) / len(kf)) if kf else None
