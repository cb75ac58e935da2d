"""Checkpoint I/O: the port's native `step_<N>` checkpoints and the loader
of a reference `.pth`.

The layout of the JAX package's `utils/checkpoint.py` (:16-126): one
`root/step_<N>/` directory per saved step, pruned to the `max_keep`
newest, with a retry into `<root>_backup` when the primary write fails
(reference aot_plus/utils/checkpoint.py:107-141, backup_dir fallback
:118-130). Each directory holds one torch file, written under a
temporary name and renamed into place, and read with `weights_only=True`:
a checkpoint holds tensors and plain containers only. The JAX package's
Orbax directories are not read by the port.

Under data parallelism the save is collective, as the JAX package's is
(:26-89): every rank calls it with the same state (the trainer's
`state_dict` gathers ZeRO-1's slices), rank 0 writes and prunes, the ranks
vote on whether the write failed and fall back to the backup root
together, and they leave together. Every rank restores from the shared
file system.

A model cut into a rank's shard of a model group (parallel/tp.py) loads
a `.pth` as a whole model does: the loader reads the model's whole
state (a collective over the group) and each rank keeps its shard of what
it loads.

The train CLI writes two kinds: `ckpt/` holds the whole train state
(`Trainer.state_dict`), `ema_ckpt/` a bare `{'state_dict': ema}` that
`load_torch_pretrained` reads as it reads a published `.pth`.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional, Tuple

import torch
from torch import nn

from rmem_ocu_tpu_torch.parallel import tp
from rmem_ocu_tpu_torch.parallel.dist import World, agree

CKPT_FILE = 'state.pth'


def backup_root_for(root: str) -> str:
    """The sibling directory a failed primary write falls back to."""
    return os.path.abspath(root).rstrip('/') + '_backup'


def step_path(root: str, step: int) -> str:
    """The file of step `step` under `root`."""
    return os.path.join(os.path.abspath(root), f'step_{step}', CKPT_FILE)


def list_checkpoint_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r'step_(\d+)', n) for n in os.listdir(root))
                  if m)


def _write(root: str, step: int, state, max_keep: int) -> None:
    path = step_path(root, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + '.tmp'
    torch.save(state, tmp)
    os.replace(tmp, path)
    for s in list_checkpoint_steps(root)[:-max_keep]:
        shutil.rmtree(os.path.dirname(step_path(root, s)),
                      ignore_errors=True)


def _attempt(root: str, step: int, state, max_keep: int, world: World):
    """Rank 0's write; the error it raised, or None."""
    if not world.is_main:
        return None
    try:
        _write(root, step, state, max_keep)
    except (OSError, RuntimeError) as err:  # torch.save's writer raises
        # RuntimeError when the disk fills
        return err
    return None


def save_checkpoint(root: str, step: int, state, max_keep: int = 8,
                    backup_root: Optional[str] = None,
                    world: World = World()) -> str:
    """Save `state` (tensors and plain containers) at `root/step_<N>`;
    prune to the `max_keep` newest steps. Collective: every rank of
    `world` calls it, and rank 0 writes.

    If the primary write fails (full, read-only or flaky filesystem), the
    half-written primary `step_<N>` is removed and the save retries once
    into `backup_root` (default `<root>_backup`), so that one bad write
    does not lose a long run's state; the ranks agree on that before any
    moves on. Raises, on every rank, only if the backup write fails too.
    Returns the path written."""
    err = _attempt(root, step, state, max_keep, world)
    if not agree(err is not None, world):
        return step_path(root, step)
    backup = backup_root or backup_root_for(root)
    if world.is_main:
        print(f'save_checkpoint: primary write to {root!r} failed '
              f'({type(err).__name__}: {err}); retrying into {backup!r}')
        # a half-written primary step must not shadow the backup copy
        shutil.rmtree(os.path.dirname(step_path(root, step)),
                      ignore_errors=True)
    err = _attempt(backup, step, state, max_keep, world)
    if agree(err is not None, world):
        if err is not None:
            raise err
        raise RuntimeError(f'save_checkpoint: rank 0 failed to write step '
                           f'{step} into {root!r} and {backup!r}')
    return step_path(backup, step)


def restore_checkpoint(root: str, target=None, step: Optional[int] = None
                       ) -> Tuple[Optional[dict], Optional[int]]:
    """Load the given (or newest) step. Returns (state, step), or
    (None, None) when there is none.

    The newest step is taken across `root` and `<root>_backup` (where
    `save_checkpoint` lands after a failed primary write), so a run that
    fell back keeps resuming. Tensors load onto the device of the
    matching tensors of `target` (a state of the same structure), or onto
    the CPU without one."""
    candidates = {root: list_checkpoint_steps(root),
                  backup_root_for(root): list_checkpoint_steps(
                      backup_root_for(root))}
    if step is None:
        src, steps = max(candidates.items(),
                         key=lambda kv: kv[1][-1] if kv[1] else -1)
        if not steps:
            return None, None
        step = steps[-1]
    else:
        src = next((r for r, ss in candidates.items() if step in ss), None)
        if src is None:
            return None, None
    state = torch.load(step_path(src, step), map_location='cpu',
                       weights_only=True)
    if target is not None:
        state = _to_devices_of(state, target)
    return state, step


def _to_devices_of(state, target):
    """`state` with each tensor moved to the device of the tensor at the
    same place in `target`."""
    if isinstance(state, torch.Tensor):
        if isinstance(target, torch.Tensor):
            return state.to(target.device)
        return state
    if isinstance(state, dict) and isinstance(target, dict):
        return {k: _to_devices_of(v, target.get(k)) for k, v in state.items()}
    return state


def load_torch_pretrained(path: str, model: nn.Module) -> List[str]:
    """Load the `.pth` at `path` (a published reference checkpoint or a
    `step_<N>` file of the port) into `model` in place with
    `load_state_dict`; the `.pth` half of the JAX package's
    `utils/checkpoint.py` (:129-161). The file is unpickled with
    `weights_only=True`: tensors and plain containers only. A
    `state_dict` wrapper is stripped."""
    blob = torch.load(path, map_location='cpu', weights_only=True)
    return load_state_dict(blob.get('state_dict', blob), model)


def load_state_dict(sd: dict, model: nn.Module) -> List[str]:
    """Load the weights `sd` into `model` in place, with the reference's
    tolerant-load quirks (aot_plus/utils/checkpoint.py:75-104):

    - the `module.` prefix of DataParallel checkpoints is stripped;
    - the id bank's input gains a zero channel when the checkpoint predates
      the ignore token (reference :89-91);
    - entries whose name or shape the model lacks are skipped, and the
      model's tensors they would have set keep their values, as in the JAX
      loader.

    Returns the names of the model's tensors kept at their current
    values."""
    sd = {k[len('module.'):] if k.startswith('module.') else k: v
          for k, v in sd.items()}
    own = tp.whole_state_dict(model) if hasattr(model, 'tp') \
        else model.state_dict()

    key = 'patch_wise_id_bank.weight'
    if key in sd and key in own:
        w = sd[key]
        if w.shape[1] == own[key].shape[1] - 1:
            sd[key] = torch.cat([w, w.new_zeros(w.shape[0], 1, *w.shape[2:])],
                                dim=1)

    loadable = {k: v for k, v in sd.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
    if hasattr(model, 'tp'):
        tp.load_whole_state_dict(model, loadable, strict=False)
    else:
        model.load_state_dict(loadable, strict=False)
    kept = sorted(set(own) - set(loadable))
    if kept:
        print(f'load_torch_pretrained: {len(kept)} params kept at init '
              f'(shape/name mismatch), e.g. {kept[:3]}')
    return kept
