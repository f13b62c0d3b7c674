"""prove_s (s, host clock): the window's wall time over the proofs
completed in it; each proof ends in torch.cuda.synchronize and its JSON."""


def read(run):
    return run.window_s / run.proofs if run.proofs else None
