"""stage4_s (s, program tick): the mean over the traced window's proofs of
stark_gen's "stage4 quotient + openings" tick (the stage-4 tree, the
openings (Lagrange iNTTs, evals), xDivXSubXi and step52ns), under
EIGEN_ZKVM_SYNC=1, which drains the device at each tick. None if the tick is
renamed."""

TICK = "stage4 quotient + openings"


def read(run):
    return run.mean_tick(TICK)
