"""launches_per_proof (count, device trace): kernels launched in the traced
window (every device interval but copies and sets) over its proofs."""


def read(run):
    if run.window is None or not run.proofs:
        return None
    return float(run.window.events.kernels.sum()) / run.proofs
