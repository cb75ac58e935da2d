"""Counts behind the prediction of Swin-B's spatial sharding; not
collected by pytest.

    python tests/spatial_swin_count.py

1. On a CPU 1 x 2 gloo world (tests/torch_dp_worker.py spawns it), one
   training step of `swinb_deaotl` with `train_spatial_sharding` at the
   recipe's rows and schedule (pre_vost_2: 464 rows, T=17, gap 4, remat
   'full', bf16 AMP), B=1, with a Swin of full depth and narrow width
   (embed 32; encoder_dim to match) on 64 px columns: each rank's halo
   exchanges and gathers of the step (`spatial.STATS`), and those the
   Swin blocks' forward and recompute make with the bytes they send.
2. In this process, the bytes of the tensors autograd saves for the
   backward of the full-width Swin-B encoder on one 224x224 bf16 frame.
"""
import os
import sys
import traceback
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_worker as worker  # noqa: E402

sys.path.insert(0, worker.REPO)

NARROW_SWIN = (32, (2, 2, 18), (2, 4, 8))


def rank_step() -> None:
    """One rank: the step and its counts, printed."""
    from rmem_ocu_tpu_torch import get_config
    from rmem_ocu_tpu_torch.parallel import dist, spatial
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    torch.set_num_threads(1)
    world = dist.init_from_env('cpu', backend='gloo', timeout_s=300, tp=2)
    exp = replace(get_config(
        'pre_vost_2', model='swinb_deaotl', train_amp=True,
        train_spatial_sharding=True, encoder_dim=(32, 64, 128, 128),
        mesh_shape=(1, 2), mesh_axes=('data', 'model')))
    model = worker.build_model({'swin': NARROW_SWIN}, exp.model, 'cpu',
                               seed=0, exp=exp)
    trainer = Trainer(model, exp, world)
    state = trainer.init_state()
    rs = np.random.RandomState(0)
    t, h, w = exp.data_seq_len, 464, 64
    batch = {'frames': torch.from_numpy(
                 rs.randn(1, t, h, w, 3).astype(np.float32)),
             'masks': torch.from_numpy(
                 (rs.rand(1, t, h, w) * 4).astype(np.int64)),
             'obj_nums': torch.tensor([3])}
    swin = [0, 0]
    exchange = spatial._exchange

    def counted(world_, sends, recvs):
        # the forward's and the recompute's exchanges run under swin.py
        n = spatial.STATS['halo']
        exchange(world_, sends, recvs)
        if spatial.STATS['halo'] > n and any(
                'swin.py' in f.filename for f in traceback.extract_stack()):
            swin[0] += 1
            swin[1] += sum(x.numel() * x.element_size() for x, _ in sends)
    spatial._exchange = counted
    spatial.reset_stats()
    trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    print(f'rank {world.rank}: T={t} gap {exp.train_long_term_mem_gap} '
          f'remat {exp.train_remat_policy}: {dict(spatial.STATS)}; Swin '
          f'blocks\' forward and recompute {swin[0]} exchanges, '
          f'{swin[1]} bytes sent', flush=True)
    dist.destroy(world)


def saved_bytes() -> int:
    """The bytes autograd saves in the Swin-B encoder's forward on one
    224x224 bf16 frame (each storage once)."""
    from rmem_ocu_tpu_torch.models.encoders.swin import SwinEncoder
    enc = SwinEncoder().to(torch.bfloat16)
    seen = {}

    def pack(x):
        seen[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        enc(torch.randn(1, 3, 224, 224, dtype=torch.bfloat16))
    return sum(seen.values())


if __name__ == '__main__':
    if 'RANK' in os.environ:
        rank_step()
    else:
        for out in worker.wait(worker.spawn(2, [os.path.abspath(__file__)]),
                               600):
            print(out.strip().splitlines()[-1])
        print(f'Swin-B saved tensors, one 224x224 bf16 frame: '
              f'{saved_bytes() / 2 ** 20:.1f} MiB')
