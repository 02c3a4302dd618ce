"""Mean of the program's own IceSheetCoupler.capture_ms entries added in
the window (one CUDA graph capture after each regeneration)."""


def read(run):
    if not run.capture_ms:
        return None
    return sum(run.capture_ms) / len(run.capture_ms)
