"""fri_s (s, program tick): the mean over the traced window's proofs of
stark_gen's "fri" tick (the FRI folds, fold trees and query gathers), under
EIGEN_ZKVM_SYNC=1, which drains the device at each tick. None if the tick is
renamed."""

TICK = "fri"


def read(run):
    return run.mean_tick(TICK)
