"""host.issue_ms: the host's time to issue one frame, the mean over the
window's untraced half of time.perf_counter around each call of
OrbitAnimator.render_frames (routing, build_params, the ctypes launch, the
staged epilogue's Python). Moves frame_ms where the host cannot keep ahead
of the device."""


def read(rec):
    if not rec.issue_ms:
        return None
    return sum(rec.issue_ms) / len(rec.issue_ms)
