"""h2d_host_ms_per_step (ms): the host's wall time inside the program's
``mvp.engine.h2d`` span (``parallel/mesh.shard_batch``, each loader
batch's copy to the card), per step of the window: how long the step's
host work waited on the copy, which the copy's device time
(``h2d_ms_per_step``) does not show."""

from benchmark import spans


def read(ctx):
    return spans.host_ms_per_step(ctx, spans.H2D)
