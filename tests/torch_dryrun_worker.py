"""One rank of ``tests/test_torch_dryrun.py``: the port's
``scripts/dryrun_multichip.py`` with the densify event's split noise
replaying the JAX trainer's draws.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tests/torch_dryrun_worker.py <noise.npy> --device cpu --out <result.json>

``noise.npy`` holds JAX's draws, (K, capacity, 3): a ``Trainer``'s k-th
``densify_noise`` returns the k-th (the port draws from a
``torch.Generator``, JAX from its PRNG key). Imports only torch, numpy and
the port.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(noise_path, argv):
    import torch

    from gaussian_splatting_lightning_tpu_torch.scripts import dryrun_multichip
    from gaussian_splatting_lightning_tpu_torch.training.trainer import Trainer

    draws = np.load(noise_path)

    def jax_noise(self):
        k = self.__dict__.setdefault("_draws", 0)
        self._draws = k + 1
        if draws.shape[1] != self.scene.capacity:
            raise ValueError(f"noise for capacity {draws.shape[1]}, the scene has "
                             f"{self.scene.capacity}")
        return torch.from_numpy(draws[k]).to(self.device)

    Trainer.densify_noise = jax_noise
    dryrun_multichip.main(argv)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
