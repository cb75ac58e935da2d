"""Loading a reference `.pth` checkpoint into the port's model.

The `.pth` half of the JAX package's `utils/checkpoint.py` (its
`load_torch_pretrained`, :129-161). The port's state_dict keys are the
reference torch keys, so a checkpoint loads with `load_state_dict` once the
reference's tolerant-load quirks (aot_plus/utils/checkpoint.py:75-104) are
applied. Orbax checkpoint directories of the JAX package are not read yet
(ROADMAP item 14).
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn


def load_torch_pretrained(path: str, model: nn.Module) -> List[str]:
    """Load the `.pth` at `path` into `model` in place.

    - a `state_dict` wrapper and the `module.` prefix of DataParallel
      checkpoints are stripped;
    - the id bank's input gains a zero channel when the checkpoint predates
      the ignore token (reference :89-91);
    - entries whose name or shape the model lacks are skipped, and the
      model's tensors they would have set keep their values, as in the JAX
      loader.

    The file is unpickled with `weights_only=True`: tensors and plain
    containers only. Returns the names of the model's tensors kept at
    their current values."""
    blob = torch.load(path, map_location='cpu', weights_only=True)
    sd = blob.get('state_dict', blob)
    sd = {k[len('module.'):] if k.startswith('module.') else k: v
          for k, v in sd.items()}
    own = model.state_dict()

    key = 'patch_wise_id_bank.weight'
    if key in sd and key in own:
        w = sd[key]
        if w.shape[1] == own[key].shape[1] - 1:
            sd[key] = torch.cat([w, w.new_zeros(w.shape[0], 1, *w.shape[2:])],
                                dim=1)

    loadable = {k: v for k, v in sd.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(loadable, strict=False)
    kept = sorted(set(own) - set(loadable))
    if kept:
        print(f'load_torch_pretrained: {len(kept)} params kept at init '
              f'(shape/name mismatch), e.g. {kept[:3]}')
    return kept
