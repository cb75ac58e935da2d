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
first step's averaged gradients and parameters), dtype (the model's and
the frames', 'float32' by default), size (of the square clips, 49 by
default, or [H, W]), deterministic (every train-time rate 0 and no id
shuffle, as the JAX package's episode runs in a check against it), swin
(the model's encoder replaced by a SwinEncoder of these (embed, depths,
heads), the config's encoder_dim set to match). A spec's `tp`
makes the world D x tp (tensor parallelism): a case then runs on a ('data',
'model') mesh, takes the rows of its data rank, and its digest holds the
whole tensors, gathered over the model group.

A case of kind 'serve' (`run_serving`) streams a clip through the
inference engine instead, the model's weights loaded from the case's
`weights` file and cut over the model group; one of kind 'gather'
(`run_gather`) differentiates through `gather_from_model`. Under spatial
sharding, one of kind 'halo' (`run_halo`) exchanges halos of a band of
rows, one of kind 'maps' (`run_maps`) runs a model's encoder, id bank
and decoder on a band, one of kind 'bands' (`run_bands`) holds the
band mean, the banded transposed conv and the half-pixel resize to the
whole map's, and one of kind 'swin' (`run_swin`) Swin's banded blocks
and patch merges and the wrapping halo exchange; these write a digest
from every rank.
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


def hw_of(size):
    """(H, W) of a case's `size`: one side of a square, or [H, W]."""
    return (size, size) if isinstance(size, int) else tuple(size)


def build_model(case, cfg, device, **kw):
    """build_vos_model of the config `cfg` on `device`, its encoder the
    case's narrow SwinEncoder where the case names one."""
    from rmem_ocu_tpu_torch import build_vos_model
    from rmem_ocu_tpu_torch.models import vos_model
    if 'swin' not in case:
        return build_vos_model(cfg, device=device, **kw)
    from rmem_ocu_tpu_torch.models.encoders.swin import SwinEncoder
    build = vos_model.build_encoder
    vos_model.build_encoder = lambda *a, **k: SwinEncoder(*case['swin'])
    try:
        return build_vos_model(cfg, device=device, **kw)
    finally:
        vos_model.build_encoder = build


def global_batch(b: int, seed: int, size=SIZE):
    rs = np.random.RandomState(seed)
    h, w = hw_of(size)
    obj_nums = np.array([2, 1, 2, 1][:b], np.int64)
    return {'frames': rs.randn(b, T, h, w, 3).astype(np.float32),
            'masks': (rs.rand(b, T, h, w)
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
    from rmem_ocu_tpu_torch.parallel.dist import same_on_all_ranks
    from rmem_ocu_tpu_torch.train import optim
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
    from rmem_ocu_tpu_torch.parallel import tp
    exp = exp_of(case)
    if world.tp > 1:
        exp = replace(exp, mesh_shape=(world.data.size, world.tp),
                      mesh_axes=('data', 'model'))
    model = build_model(case, exp.model, world.device,
                        seed=case.get('seed', 0), exp=exp)
    dtype = getattr(torch, case.get('dtype', 'float32'))
    model.to(dtype)
    trainer = Trainer(model, exp, world)
    if case.get('deterministic'):
        from functools import partial
        from rmem_ocu_tpu_torch.models.vos_model import zero_dropout
        zero_dropout(model)
        trainer.engine.episode_loss = partial(trainer.engine.episode_loss,
                                              enable_id_shuffle=False)
    state = trainer.init_state()
    names = [k for k, _ in model.named_parameters()]
    digest = {'steps': [], 'split': list(trainer.layout)}
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
    digest['weights0'] = flat({
        k: v for k, v in tp.whole_state_dict(model).items()
        if v.is_floating_point()})
    generator = torch.Generator().manual_seed(1)
    clip = optim.clip_by_global_norm

    def capture(grads, *args, **kw):
        # the averaged gradients, whole; whether the whole parameters'
        # are alike on the ranks of each model group
        seen.append({k: v.clone() for k, v in
                     trainer._whole(grads).items()})
        digest['whole_grads_alike'] = same_on_all_ranks(
            [g for k, g in grads.items() if k not in trainer.layout],
            world.model)
        return clip(grads, *args, **kw)
    for i in range(case['steps']):
        batch = rank_rows(global_batch(case['batch'], 3 + i,
                                       case.get('size', SIZE)),
                          world.data.rank, world.data.size, world.device)
        batch['frames'] = batch['frames'].to(dtype)
        seen = []
        if case.get('capture') and i == 0:
            optim.clip_by_global_norm = capture
        try:
            state, m = trainer.train_step(state, batch, generator)
        finally:
            optim.clip_by_global_norm = clip
        digest['steps'].append({
            k: (m[k].tolist() if torch.is_tensor(m[k]) else m[k])
            for k in ('loss', 'aux_loss', 'pred_loss', 'iou', 'lr',
                      'grad_norm', 'frame_losses', 'frame_ious', 'var_loss')
            if k in m})
        if seen:
            digest['grads'] = {k: v.cpu() for k, v in seen[0].items()}
            whole = tp.whole_state_dict(model)
            digest['params_1'] = {k: whole[k].cpu().clone() for k in names}
    saved = trainer.state_dict(state)
    digest['weights'] = flat({k: v for k, v in saved['state_dict'].items()
                              if v.is_floating_point()})
    digest['ema'] = flat(saved['ema'])
    digest['same_on_ranks'] = same_on_all_ranks(
        [digest['weights'].to(world.device), digest['ema'].to(world.device)],
        world)
    moments = state.opt_state.get('mu', state.opt_state.get('trace'))
    big = max(moments, key=lambda k: model.get_parameter(k).numel())
    digest['largest_moment'] = (model.get_parameter(big).numel(),
                                moments[big].numel())
    if case.get('save'):
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
            [torch.tensor([zlib.crc32(path.encode())], device=world.device)],
            world)
    return digest


SERVE_SIZE, SERVE_FRAMES = 49, 6


def serving_clip(seed: int):
    """(first frame [1, S, S, 3], its mask of 2 objects [1, S, S], the
    next frames), float32 / int64 numpy, near the first frame."""
    rs = np.random.RandomState(seed)
    s = SERVE_SIZE
    img0 = rs.randn(1, s, s, 3).astype(np.float32)
    mask0 = (rs.rand(1, s, s) * 3).astype(np.int64)
    frames = [(rs.randn(1, s, s, 3) * 0.5 + img0).astype(np.float32)
              for _ in range(SERVE_FRAMES)]
    return img0, mask0, frames


def serving_exp(case):
    from rmem_ocu_tpu_torch import get_config
    return get_config('pre_vost', model=case['model'],
                      **case.get('overrides', {}))


def run_serving(case, world):
    """Stream the clip of case['seed'] at write gap 1 through the engine
    on this rank's shard; returns each frame's logits and prediction, the
    bank's frame ids after each update, and whether every rank holds the
    same logits."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model
    from rmem_ocu_tpu_torch.parallel import tp
    from rmem_ocu_tpu_torch.parallel.dist import same_on_all_ranks
    exp = serving_exp(case)
    model = build_vos_model(exp.model, device=world.device)
    model.load_state_dict(torch.load(case['weights']), strict=True)
    tp.shard_model(model, world.model)
    eng = InferEngine(model, exp, long_term_mem_gap=1)
    img0, mask0, frames = serving_clip(case['seed'])
    grid = ((SERVE_SIZE - 1) // 16 + 1,) * 2
    st = eng.init_state(1, grid)
    st = eng.add_reference_frame(st, torch.from_numpy(img0),
                                 torch.from_numpy(mask0), torch.tensor([2]))
    digest = {'logits': [], 'preds': [], 'ids': []}
    for f in frames:
        logits, st = eng.propagate(st, torch.from_numpy(f))
        pred = eng.predict_mask(logits, (SERVE_SIZE, SERVE_SIZE))
        st = eng.update_memory(st, pred)
        digest['logits'].append(logits.cpu().clone())
        digest['preds'].append(pred.cpu().clone())
        digest['ids'].append(st.bank.ordered_frame_ids.cpu().clone())
    digest['same_on_ranks'] = same_on_all_ranks(
        [torch.stack(digest['logits'])], world)
    digest['bank_bytes'] = sum(
        x.numel() * x.element_size()
        for x in st.bank.k + st.bank.v + (st.bank.id_v or []))
    return digest


def run_gather(case, world):
    """x, this model rank's two-segment shard of a whole [3, 8] tensor,
    gathered whole and multiplied by a rank's own weights: returns the
    gathered tensor and every rank's gradient of its shard, put together
    in the whole's layout."""
    from rmem_ocu_tpu_torch.parallel import dist
    from rmem_ocu_tpu_torch.parallel.layers import gather_from_model
    from rmem_ocu_tpu_torch.parallel.tp import ranges_of
    mw = world.model
    whole, weights = gather_operands(mw.size)
    mine = ranges_of((4, 4), mw.rank, mw.size)
    x = dist.take(whole, mine).clone().requires_grad_()
    y = gather_from_model(x, mw, mine, 8)
    (y * weights[mw.rank]).sum().backward()
    return {'y': y.detach(),
            'grad': dist.all_gather(x.grad, mw, mine, 8)}


HALO_ROWS = 11                  # a whole map of 11 rows: 6 + 5 at M=2
HALO_CASES = ((1, 1, 0.0, None), (3, 2, 0.0, (3, 3)), (1, 0, -1.0, (1, 1)),
              (0, 2, 0.0, None), (2, 0, 0.0, (0, 4)))


def halo_operands(n: int):
    """A whole [2, 3, HALO_ROWS, 5] map, each rank's first row (M=n), and
    per HALO_CASES entry (top, bottom, fill, edge) a weight for each
    rank's band with its halo."""
    rs = np.random.RandomState(4)
    starts = [r * -(-HALO_ROWS // n) for r in range(n)] + [HALO_ROWS]
    x = torch.from_numpy(rs.randn(2, 3, HALO_ROWS, 5))
    weights = []
    for top, bottom, _, edge in HALO_CASES:
        edge = edge or (top, bottom)
        rows = [(top if r else edge[0]) + starts[r + 1] - starts[r]
                + (bottom if r < n - 1 else edge[1]) for r in range(n)]
        weights.append([torch.from_numpy(rs.randn(2, 3, k, 5))
                        for k in rows])
    return x, starts, weights


def run_halo(case, world):
    """This model rank's band of halo_operands' map with each case's halo,
    and the gradient of sum(band * weight) with respect to its band."""
    from rmem_ocu_tpu_torch.parallel.spatial import halo_rows
    mw = world.model
    x, starts, weights = halo_operands(mw.size)
    out = {'per_rank': True, 'ext': [], 'grad': []}
    for (top, bottom, fill, edge), w in zip(HALO_CASES, weights):
        band = x[..., starts[mw.rank]:starts[mw.rank + 1], :].clone()
        band.requires_grad_()
        ext = halo_rows(band, top, bottom, mw, fill, edge)
        (ext * w[mw.rank]).sum().backward()
        out['ext'].append(ext.detach())
        out['grad'].append(band.grad)
    return out


def run_maps(case, world):
    """The case's model (eval, frozen BN; `overrides` of its config) on
    this model rank's band of a clip of `size` px (49 by default, or
    [H, W]; the case's narrow Swin where it names one): the
    rows each banded convolution's input holds against its band's rows at
    its stride, the (stride, whole rows) each banded transposed conv is
    told with the rows its input holds, and the largest difference of the
    band's encoder maps, id tokens and decoded logits from the whole
    image's computed here without bands. A mask-conditioned encoder takes
    the clip's labels; its maps without them are held too."""
    from rmem_ocu_tpu_torch import get_config
    from rmem_ocu_tpu_torch.parallel import spatial
    exp = get_config('pre_vost', model=case['model'],
                     **case.get('overrides', {}))
    cfg = exp.model
    h, w = hw_of(case.get('size', SIZE))
    dtype = getattr(torch, case.get('dtype', 'float32'))
    model = build_model(case, cfg, world.device).to(dtype)
    bands = spatial.make_bands((h, w), world.model)
    rs = np.random.RandomState(6)
    img = torch.from_numpy(rs.randn(2, h, w, 3)).to(dtype)
    ids = torch.from_numpy(rs.randint(0, 3, (2, h, w)))
    one_hot = torch.nn.functional.one_hot(ids, cfg.id_dim).to(dtype)
    # the transformer's outputs on the whole 16x grid: a GPM layer's
    # [tgt, tgt_id], or each LSTT layer's tgt
    d = cfg.encoder_embedding_dim
    n_out = cfg.lstt_num if cfg.decoder_intermediate_lstt else 1
    lstt_out = [torch.from_numpy(rs.randn(
        2, bands.whole_rows(16) * -(-w // 16),
        2 * d if cfg.vos == 'deaot' else d)).to(dtype)
        for _ in range(n_out)]
    first, end = bands.rows(1)
    inputs, t_inputs = [], []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: inputs.append((bands.level(a[0].shape[-1]),
                                    a[0].shape[-2])))
        for m in model.modules() if isinstance(m, spatial.Conv2d)]
    hooks += [m.register_forward_pre_hook(
        lambda m, a: t_inputs.append((a[1], a[0].shape[-2])))
        for m in model.modules() if isinstance(m, spatial.ConvTranspose2d)]
    labels = ids[..., None] if cfg.use_mask else None

    def run(banded, mask):
        rows = slice(first, end) if banded else slice(None)
        m = None if mask is None else mask[:, rows]
        with spatial.banded(bands if banded else None), torch.no_grad():
            xs = model.encode_image(img[:, rows], m)
            tokens = model.get_id_emb(one_hot[:, rows])
            return xs, tokens, model.decode_id_logits(lstt_out, xs)
    whole = run(False, labels)
    inputs.clear()
    t_inputs.clear()
    mine = run(True, labels)
    for h in hooks:
        h.remove()
    rows = lambda m: slice(*bands.rows(bands.level(m.shape[-1])))
    err = lambda a, b: max(float((m - w[..., rows(m), :]).abs().max())
                           for m, w in zip(a, b))
    logits = mine[2].permute(0, 3, 1, 2)
    out = {'per_rank': True, 'conv_inputs': inputs,
           'transposed_inputs': [(at, n, bands.rows(at[0], None, at[1]))
                                 for at, n in t_inputs],
           'band_rows': {s: bands.rows(s) for s in spatial.STRIDES},
           'map_rows': [x.shape[-2] for x in mine[0]],
           'map_err': err(mine[0], whole[0]),
           'token_err': float((mine[1] - whole[1]).abs().max()),
           'logit_rows': logits.shape[-2],
           'logit_err': float((logits - whole[2].permute(0, 3, 1, 2)[
               ..., slice(*bands.rows(4)), :]).abs().max())}
    if labels is not None:
        plain = run(False, None)[0]
        out['unmasked_err'] = err(run(True, None)[0], plain)
        out['mask_moves'] = float((plain[2] - whole[0][2]).abs().max())
    return out


# the TopDown decoders' transposed convs (in, out, k, s, p), narrowed,
# and the stride of the map each reads
DECODER_CONVS = (((16, 8, 3, 2, 1), 16), ((8, 4, 7, 2, 3), 2),
                 ((8, 4, 3, 1, 1), 4))
# images of 1, not 1 and 1 (mod 16) px; the transposed convs at the first
# two
BAND_SIZES = (49, 72, 465)


def _interp(x, size):
    return torch.nn.functional.interpolate(x, size=size, mode='bilinear',
                                           align_corners=False)


def run_bands(case, world):
    """On this model rank, in float64, at images of BAND_SIZES px: the
    band mean, half-pixel resizes (the oracle's mask from 1x to the 16x
    grid, 16x to 4x, and at a size not 1 (mod 16) a transposed conv's 4x
    map of one row and column too few to the stage's) and, with the
    case's `transposed`, each
    TopDown transposed conv at the first two sizes, against the
    whole map's, forward and backward: each rank's loss weighs its band's
    output by its own weights, and the whole map's reference sums every
    rank's. Returns each check's largest forward and input-gradient
    difference, and for the transposed convs this rank's weight and bias
    gradients beside the whole map's (the ranks' sum is the whole's)."""
    from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
    from rmem_ocu_tpu_torch.parallel import spatial
    mw = world.model
    out = {'per_rank': True, 'checks': {}, 'param_grads': {}}

    def hold(name, size, fn, whole_fn, x, at, out_at, module=None):
        """fn(band, bands) against whole_fn(whole)'s band; `at` and
        `out_at` are the (stride, whole rows) of the input's and the
        output's maps (None: the output is whole on every rank)."""
        bands = spatial.make_bands((size, size), mw)
        rows = lambda a, r=None: (slice(None) if a is None else
                                  slice(*bands.rows(a[0], r, a[1])))
        params = [] if module is None else list(module.parameters())
        whole = x.clone().requires_grad_()
        want = whole_fn(whole)
        rs = np.random.RandomState(zlib.crc32(name.encode()))
        weights = [torch.from_numpy(rs.randn(
            *want[..., rows(out_at, r), :].shape)) for r in range(mw.size)]
        sum((want[..., rows(out_at, r), :] * weights[r]).sum()
            for r in range(mw.size)).backward()
        whole_grads = [p.grad.clone() for p in params]
        for p in params:
            p.grad = None
        band = x[..., rows(at), :].clone().requires_grad_()
        with spatial.banded(bands):
            got = fn(band, bands)
        (got * weights[mw.rank]).sum().backward()
        out['checks'][name] = (
            float((got - want[..., rows(out_at), :]).abs().max().detach()),
            float((band.grad - whole.grad[..., rows(at), :]).abs().max()))
        if params:
            out['param_grads'][name] = ([p.grad.clone() for p in params],
                                        whole_grads)
            for p in params:
                p.grad = None

    for size in BAND_SIZES:
        rs = np.random.RandomState(size)
        x = torch.from_numpy(rs.randn(2, 3, size, size))
        n16, n4 = -(-size // 16), -(-size // 4)
        band_rows = lambda s, n: len(range(*spatial.make_bands(
            (size, size), mw).rows(s, None, n)))
        hold(f'mean {size}', size,
             lambda b, bands: spatial.mean_hw(b, bands, True),
             lambda w: w.mean(dim=(2, 3), keepdim=True), x, (1, size), None)
        hold(f'resize 1x to 16x {size}', size,
             lambda b, bands: interpolate_bilinear(
                 b, (band_rows(16, n16), n16), False, bands),
             lambda w: _interp(w, (n16, n16)), x, (1, size), (16, n16))
        if size % 16 != 1:
            # the TopDown decoders' 4x maps hold a row and column less
            small = x[..., :n4 - 1, :n4 - 1].contiguous()
            hold(f'resize 4x {n4 - 1} to {n4} {size}', size,
                 lambda b, bands: interpolate_bilinear(
                     b, (band_rows(4, n4), n4), False, bands,
                     ((4, n4 - 1), (4, n4))),
                 lambda w: _interp(w, (n4, n4)), small, (4, n4 - 1),
                 (4, n4))
        grid = x[..., :n16, :n16].contiguous()
        hold(f'resize 16x to 4x {size}', size,
             lambda b, bands: interpolate_bilinear(
                 b, (band_rows(4, n4), n4), False, bands),
             lambda w: _interp(w, (n4, n4)), grid, (16, n16), (4, n4))
        if size == BAND_SIZES[-1] or not case.get('transposed'):
            continue
        for i, (spec, s) in enumerate(DECODER_CONVS):
            torch.manual_seed(i)
            conv = spatial.ConvTranspose2d(*spec).double()
            at = (s, -(-size // s))
            inp = torch.from_numpy(rs.randn(2, spec[0], at[1], at[1]))
            hold(f'transposed conv {spec} {size}', size,
                 lambda b, bands: conv(b, at), conv, inp, at,
                 spatial.transposed_rows(conv, at), conv)
    return out


# a narrow Swin (embed, depths, heads) and a width that names each stride
SWIN_NARROW = (32, (2, 2, 2), (2, 4, 8))
SWIN_WIDTH = 64
# the wrap's operands: a map of WRAP_ROWS rows; by M, the rows each rank
# takes above and below (as many as its neighbours hold at most)
WRAP_ROWS = 17
WRAP_HALOS = {2: ((4, 1), (3, 5)), 4: ((2, 0, 3, 1), (1, 3, 2, 3))}


def _swin_modules(dim: int, heads: int, merge: bool):
    """A stage's unshifted and shifted blocks (and its merge), float64,
    every parameter drawn at random (the relative bias too)."""
    from rmem_ocu_tpu_torch.models.encoders.swin import (PatchMerging,
                                                         SwinBlock)
    mods = {f'block shift {k}': SwinBlock(dim, heads, 7, k) for k in (0, 3)}
    if merge:
        mods['merge'] = PatchMerging(dim)
    for mod in mods.values():
        mod.double()
        with torch.no_grad():
            for p in mod.parameters():
                p.add_(torch.randn_like(p) * 0.2)
    return mods


def run_swin(case, world):
    """On this model rank, in float64, at images of case['sizes'] rows by
    SWIN_WIDTH px: the narrow Swin's blocks, unshifted and shifted, at
    strides 4, 8 and 16 and its patch merges at 4 and 8, each on the
    rank's band of a random map, against the whole map's, forward and
    backward (each rank weighs its band's output by weights of its own;
    the whole map's reference sums every rank's); then the wrapping halo
    exchange of WRAP_HALOS against torch.roll of a whole map. Returns each
    check's largest forward and input-gradient difference, and this
    rank's parameter gradients beside the whole map's (the ranks' sum is
    the whole's)."""
    from rmem_ocu_tpu_torch.parallel import spatial
    mw = world.model
    out = {'per_rank': True, 'checks': {}, 'param_grads': {}}
    embed, _, heads = SWIN_NARROW
    for size in case['sizes']:
        bands = spatial.make_bands((size, SWIN_WIDTH), mw)
        for i, s in enumerate((4, 8, 16)):
            torch.manual_seed(size + i)
            h, w = bands.whole_rows(s), -(-SWIN_WIDTH // s)
            c = embed * 2 ** i
            rs = np.random.RandomState(size + i)
            x = torch.from_numpy(rs.randn(2, h, w, c))
            for name, mod in _swin_modules(c, heads[i], s < 16).items():
                # the map after it: its stride and channels
                t, c_out = (2 * s, 2 * c) if name == 'merge' else (s, c)
                run = lambda z, n: mod(z.reshape(2, -1, c), n, w)
                whole = x.clone().requires_grad_()
                want = run(whole, h).reshape(2, bands.whole_rows(t), -1,
                                             c_out)
                weights = [torch.from_numpy(rs.randn(
                    *want[:, slice(*bands.rows(t, r))].shape))
                    for r in range(mw.size)]
                sum((want[:, slice(*bands.rows(t, r))] * weights[r]).sum()
                    for r in range(mw.size)).backward()
                whole_grads = [p.grad.clone() for p in mod.parameters()]
                mod.zero_grad()
                rows = slice(*bands.rows(s))
                band = x[:, rows].clone().requires_grad_()
                with spatial.banded(bands):
                    got = run(band, band.shape[1]).reshape(
                        2, -1, *want.shape[2:])
                (got * weights[mw.rank]).sum().backward()
                key = f'{name} stride {s} {size}'
                out['checks'][key] = (
                    float((got - want[:, slice(*bands.rows(t))]).abs()
                          .max()),
                    float((band.grad - whole.grad[:, rows]).abs().max()))
                out['param_grads'][key] = (
                    [p.grad.clone() for p in mod.parameters()], whole_grads)
    # the wrap: rank r's band with tops[r] rows above and bottoms[r]
    # below, taken round the map's edges
    tops, bottoms = WRAP_HALOS[mw.size]
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(2, 3, WRAP_ROWS, 5))
    starts = [r * -(-WRAP_ROWS // mw.size) for r in range(mw.size)] + [
        WRAP_ROWS]
    whole = x.clone().requires_grad_()
    weights, wants = [], []
    for r in range(mw.size):
        n = starts[r + 1] - starts[r] + tops[r] + bottoms[r]
        wants.append(torch.roll(whole, tops[r] - starts[r], -2)[..., :n, :])
        weights.append(torch.from_numpy(rs.randn(*wants[-1].shape)))
    sum((a * b).sum() for a, b in zip(wants, weights)).backward()
    band = x[..., starts[mw.rank]:starts[mw.rank + 1], :].clone()
    band.requires_grad_()
    got = spatial.halo_rows(band, tops, bottoms, mw, wrap=True)
    (got * weights[mw.rank]).sum().backward()
    out['checks']['wrap'] = (
        float((got - wants[mw.rank]).abs().max().detach()),
        float((band.grad - whole.grad[
            ..., starts[mw.rank]:starts[mw.rank + 1], :]).abs().max()))
    return out


def gather_operands(n: int):
    rs = np.random.RandomState(0)
    return (torch.from_numpy(rs.randn(3, 8)),
            [torch.from_numpy(rs.randn(3, 8)) for _ in range(n)])


RUNS = {'train': run_case, 'serve': run_serving, 'gather': run_gather,
        'halo': run_halo, 'maps': run_maps, 'bands': run_bands,
        'swin': run_swin}


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    # f32 convolutions on the card, as the parent's one process runs them
    torch.backends.cudnn.allow_tf32 = False
    from rmem_ocu_tpu_torch.parallel import dist
    with open(spec_path) as f:
        spec = json.load(f)
    world = dist.init_from_env(spec['device'], backend=spec['backend'],
                               timeout_s=spec['timeout'],
                               tp=spec.get('tp', 1))
    try:
        for case in spec['cases']:
            digest = RUNS[case.get('kind', 'train')](case, world)
            if digest.get('per_rank'):
                torch.save(digest, digest_path(
                    spec['out'], f'{case["name"]}_r{world.rank}',
                    world.size))
            elif world.is_main:
                torch.save(digest, digest_path(spec['out'], case['name'],
                                               world.size))
            print(f'rank {world.rank}: {case["name"]} ok', flush=True)
    finally:
        dist.destroy(world)


if __name__ == '__main__':
    main(sys.argv[1])
