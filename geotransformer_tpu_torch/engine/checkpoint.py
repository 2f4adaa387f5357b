r"""Checkpoints with ``torch.save`` (``geotransformer_tpu/engine/checkpoint.py``;
reference `engine/base_trainer.py:112-177`).

One directory per saved step under ``directory`` (``<step>/state.pt``),
written to a temporary name and renamed, so a checkpoint is whole or
absent. As the JAX package's orbax manager: ``max_to_keep`` most recent
steps are kept (None keeps all), the latest step is the largest, and
restoring a missing step raises ``FileNotFoundError``. In a process group
rank 0 writes (and prunes), then every rank passes a barrier, so no rank
reads a checkpoint before it is whole; every rank restores.
"""

import os
import shutil

import torch

from geotransformer_tpu_torch.parallel import mesh

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory, max_to_keep=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self):
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(os.path.join(self.directory, name, _FILE)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, state, metadata=None):
        """Save ``state`` (a dict of state_dicts, tensors and numbers) and
        optional metadata at ``step`` (rank 0 writes; every rank waits)."""
        if mesh.rank() == 0:
            self._write(step, state, metadata)
        mesh.barrier()

    def _write(self, step, state, metadata):
        final = os.path.join(self.directory, str(int(step)))
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save({"state": state, "metadata": metadata}, os.path.join(tmp, _FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step=None, map_location="cpu"):
        """(state, step) of ``step``, by default the latest."""
        step = self.latest_step() if step is None else int(step)
        path = None if step is None else os.path.join(self.directory, str(step), _FILE)
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint {'' if step is None else step} in "
                                    f"{self.directory}")
        payload = torch.load(path, map_location=map_location, weights_only=True)
        return payload["state"], step
