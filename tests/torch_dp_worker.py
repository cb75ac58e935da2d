"""One rank of a data-parallel world of the port's Trainer, and the helpers
that spawn such a world; not collected by pytest. It imports no JAX, so
the card's test (tests/test_torch_kernels_cuda.py) runs it too.

    python tests/torch_dp_worker.py SPEC.json

runs under torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT; `spawn` sets them) with the spec's device and
backend, runs each case of the spec on a gloo (or NCCL) group, and writes
each case's digest (`digest_path`) from rank 0. The parent test runs the
same cases at world 1 in its own process with `run_case` and holds the
two digests against each other.

A case trains `steps` steps of a small model (49x49 clips, T=3, gap 1)
on the rows of this rank of a global batch of `batch` samples made from
a seed with numpy, with the episodes' generator seeded alike on every
rank. Keys: name, model, steps, batch, zero1, remat, overrides (config
fields), seed (of the model's weights), save (a checkpoint root written
after the steps), flaky_save (rank 0's first write of that save fails),
restore (a checkpoint root restored before them), capture (keep the
first step's averaged gradients and parameters).
"""
import json
import os
import socket
import subprocess
import sys
import zlib
from dataclasses import replace

import numpy as np
import torch

SIZE, T = 49, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn(n: int, argv, cwd=None, local_ranks=None):
    """Start n processes of `python argv...` as ranks of one world on
    this host, one torch thread each. local_ranks defaults to the ranks
    (one card each); [0] * n puts every rank on card 0."""
    port = str(free_port())
    local_ranks = local_ranks or list(range(n))
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(local_ranks[r]), MASTER_ADDR='127.0.0.1',
                   MASTER_PORT=port, OMP_NUM_THREADS='1',
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get('PYTHONPATH', ''))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=env, cwd=cwd or REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait(procs, timeout: float):
    """The outputs of the processes; raises if one fails or outlives
    `timeout` seconds (and then kills them all)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f'rank {r} exited {p.returncode}:\n'
                               f'{out[-6000:]}')
    return outs


def digest_path(out_dir: str, name: str, world: int) -> str:
    return os.path.join(out_dir, f'{name}_w{world}.pt')


def exp_of(case):
    from rmem_ocu_tpu_torch import get_config
    exp = get_config('pre_vost', model=case['model'], data_seq_len=T,
                     train_total_steps=100, **case.get('overrides', {}))
    return replace(exp, train_long_term_mem_gap=1,
                   train_zero1=case.get('zero1', False),
                   train_remat_policy=case.get('remat', 'none'))


def global_batch(b: int, seed: int):
    rs = np.random.RandomState(seed)
    obj_nums = np.array([2, 1, 2, 1][:b], np.int64)
    return {'frames': rs.randn(b, T, SIZE, SIZE, 3).astype(np.float32),
            'masks': (rs.rand(b, T, SIZE, SIZE)
                      * (obj_nums[:, None, None, None] + 1)).astype(np.int64),
            'obj_nums': obj_nums}


def rank_rows(batch, rank: int, world: int, device):
    n = len(batch['obj_nums']) // world
    return {k: torch.from_numpy(v[rank * n:(rank + 1) * n]).to(device)
            for k, v in batch.items()}


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1).cpu()
                      for t in tensors.values()])


def run_case(case, world):
    """Train the case on this rank of `world`; returns its digest: losses
    and metrics of each step (the world's means), the parameters, buffers
    and EMA after the last step (flat), whether every rank holds the
    same, the largest moment's size whole and on this rank, and what the
    case's restore and capture found."""
    from rmem_ocu_tpu_torch import build_vos_model
    from rmem_ocu_tpu_torch.parallel.dist import same_on_all_ranks
    from rmem_ocu_tpu_torch.train import optim
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
    exp = exp_of(case)
    model = build_vos_model(exp.model, device=world.device,
                            seed=case.get('seed', 0), exp=exp)
    trainer = Trainer(model, exp, world)
    state = trainer.init_state()
    digest = {'steps': []}
    if case.get('restore'):
        restored, _ = ckpt.restore_checkpoint(case['restore'],
                                              trainer.state_dict(state))
        state = trainer.load_state_dict(restored)
        back = trainer.state_dict(state)
        digest['restored_equal'] = all(
            torch.equal(back[part][k], v.to(back[part][k].device))
            for part in ('state_dict', 'ema') for k, v in
            restored[part].items()) and all(
            torch.equal(back['opt_state'][m][k], v)
            for m in ('mu', 'nu') for k, v in
            restored['opt_state'][m].items()) and (
            back['step'], back['opt_state']['count']) == (
            restored['step'], restored['opt_state']['count'])
    digest['weights0'] = flat({k: v for k, v in model.state_dict().items()
                               if v.is_floating_point()})
    generator = torch.Generator().manual_seed(1)
    norm = optim.global_norm
    for i in range(case['steps']):
        batch = rank_rows(global_batch(case['batch'], 3 + i), world.rank,
                          world.size, world.device)
        seen = []
        if case.get('capture') and i == 0:
            optim.global_norm = lambda g: seen.append(
                {k: v.clone() for k, v in g.items()}) or norm(g)
        try:
            state, m = trainer.train_step(state, batch, generator)
        finally:
            optim.global_norm = norm
        digest['steps'].append({
            k: (m[k].tolist() if torch.is_tensor(m[k]) else m[k])
            for k in ('loss', 'aux_loss', 'pred_loss', 'iou', 'lr',
                      'grad_norm', 'frame_losses', 'frame_ious')})
        if seen:
            digest['grads'] = {k: v.cpu() for k, v in seen[0].items()}
            digest['params_1'] = {k: p.detach().cpu().clone() for k, p in
                                  model.named_parameters()}
    weights = {k: v for k, v in model.state_dict().items()
               if v.is_floating_point()}
    digest['weights'] = flat(weights)
    digest['ema'] = flat(state.ema)
    digest['same_on_ranks'] = same_on_all_ranks(
        [digest['weights'], digest['ema']], world)
    moments = state.opt_state.get('mu', state.opt_state.get('trace'))
    big = max(moments, key=lambda k: model.get_parameter(k).numel())
    digest['largest_moment'] = (model.get_parameter(big).numel(),
                                moments[big].numel())
    if case.get('save'):
        saved = trainer.state_dict(state)
        save = torch.save
        if case.get('flaky_save') and world.is_main:
            def flaky(obj, path):
                torch.save = save
                raise OSError(28, 'No space left on device')
            torch.save = flaky
        try:
            path = ckpt.save_checkpoint(case['save'], state.step, saved,
                                        world=world)
        finally:
            torch.save = save
        digest['saved_to'] = path
        digest['saved_alike'] = same_on_all_ranks(
            [torch.tensor([zlib.crc32(path.encode())])], world)
    return digest


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    # f32 convolutions on the card, as the parent's one process runs them
    torch.backends.cudnn.allow_tf32 = False
    from rmem_ocu_tpu_torch.parallel import dist
    with open(spec_path) as f:
        spec = json.load(f)
    world = dist.init_from_env(spec['device'], backend=spec['backend'],
                               timeout_s=spec['timeout'])
    try:
        for case in spec['cases']:
            digest = run_case(case, world)
            if world.is_main:
                torch.save(digest, digest_path(spec['out'], case['name'],
                                               world.size))
            print(f'rank {world.rank}: {case["name"]} ok', flush=True)
    finally:
        dist.destroy(world)


if __name__ == '__main__':
    main(sys.argv[1])
