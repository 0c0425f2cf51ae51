"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``).

The reference's only parallelism is single-node DDP over NCCL (SURVEY
§2.6). Here each rank is one process on one card, started by ``torchrun``:
``multihost.initialize`` joins the process group, each rank's loader reads
its shard of the dataset, and ``ProbeTrainer`` takes the step of the
global batch (every loss normalisation and BatchNorm statistic summed over
the ranks, the gradients summed over the ranks). ``pipeline`` is the GPipe
runner over point-to-point sends between ranks, which no driver uses.
"""

from midvision_probe_torch.parallel.mesh import (  # noqa: F401
    check_num_devices,
    replicate,
    shard_batch,
)
