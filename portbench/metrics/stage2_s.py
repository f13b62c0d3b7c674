"""stage2_s (s, program tick): the mean over the traced window's proofs of
stark_gen's "stage2 h1/h2 commit" tick (stage-2 LDE and tree, step3prev, the
grand products Z and step3), under EIGEN_ZKVM_SYNC=1, which drains the
device at each tick. None if the tick is renamed."""

TICK = "stage2 h1/h2 commit"


def read(run):
    return run.mean_tick(TICK)
