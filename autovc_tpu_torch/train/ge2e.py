"""GE2E speaker-encoder checkpoints.

Counterpart of the loading half of ``autovc_tpu/train/ge2e.py``: the trainer
itself (``GE2ETrainer``, the GE2E loss and ``cli.train_speaker_encoder``) is
not ported yet (ROADMAP Queue 1 #5); checkpoints it wrote, such as
``artifacts/ge2e.npz`` and ``artifacts/ge2e_indep.npz``, load here.
"""

from __future__ import annotations

import numpy as np

from autovc_tpu_torch.io import unflatten_params


def load_params(path: str) -> dict:
    """The flat ``.npz`` of a GE2E checkpoint -> its nested tree
    (``{'dvector': {'lstm', 'embedding'}, 'w', 'b'}``), numpy leaves as
    stored, as ``GE2ETrainer.load_params`` returns it."""
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})
