"""Spatial sharding of training over a model group: bands of H rows.

The counterpart of the JAX package's `train_spatial_sharding`
(rmem_ocu_tpu/train/trainer.py:138-147), which constrains the episode's
frames and masks to P('data', None, 'model') and lets GSPMD partition the
encoder's and decoder's convolutions with halo exchanges. Here every part
is explicit. The M ranks of a model group split the image's rows into
bands whose boundaries fall on the 16x grid: rank r owns the pixel rows
[start_r, start_r+1), the grid's rows dealt out as evenly as they go,
the first ranks taking one more (465 px, 30 grid rows: 240 + 225 px at
M=2; 8/8/7/7 grid rows at M=4). A map at stride s holds the rows
[start_r / s, start_r+1 / s) of the whole map, the last rank up to the
whole map's ceil(H / s) rows: the arithmetic of the odd sizes the
encoders produce, 465 -> 233 -> 117 -> 59 -> 30. Every map of the
encoders the knob supports has ceil(W / s) columns, so a map's width
names its stride (`Bands.level`), but for the maps of the TopDown
encoder's transposed convolutions, whose s (n - 1) - 2p + k rows and
columns need not be ceil(H / s): their callers give the stride and the
whole map's rows (`rows(stride, whole=)`). Swin-B's maps are ceil(H / s)
rows too: its 4x patches and 2x2 merges read their band's own rows, as a
band starts on an even row at every stride; only the last rank pads the
image's bottom to whole patches and an odd map's last row.

The pieces:

- `halo_rows`: a band with `top` rows of the rank above and `bottom` rows
  of the rank below (one count, or one for each rank), exchanged with
  `batch_isend_irecv`; at the image's edge the layer's own padding, or
  with `wrap` (a roll of the rows) the rows of the rank at the other
  edge. Its backward sends each halo row's gradient back to the rank
  that owns the row.
- `window_halos` and `window_rows`: Swin's windows of 7 rows, which start
  at rows 7k (7k + 3 in the shifted blocks, modulo the map's rows padded
  to whole windows, hp). Bands start on the 16x grid, not on windows, so
  a band takes the rows that complete the windows meeting it, a count
  of its own above and below (at most 6; the last rank's band holds the
  pad rows). In the shifted blocks rank 0's first windows are the whole
  map's last, which hold the last rows of the padded map above its first
  rows (torch.roll's wrap): rank 0 takes the last rank's last rows above
  its band, and the last rank rank 0's first rows below its own. Each
  rank attends over its windows and keeps its own rows' outputs, so a
  window that two bands share is computed on both and each (query, key)
  pair counts once over the group.
- `Conv2d` and `max_pool_3x3_s2`: an output band reads input rows
  [o0 s - p, (o1 - 1) s - p + d (k - 1)], so the band takes p rows above
  (a band starts at a multiple of the stride) and d (k - 1) - p - s + 1
  below, and runs with padding (0, p). Only the rows a layer reads cross
  the group. A 1x1 convolution reads its own rows and stays nn.Conv2d.
- `avg_pool_3x3`: ResNeSt's avd pool (count_include_pad), as the max
  pool, with zero rows at the image's edge.
- `ConvTranspose2d`: an output band [o0, o1) reads the input rows
  ceil((o0 + p - k + 1) / s) to floor((o1 - 1 + p) / s); the band takes
  those rows, runs without row padding and keeps its rows of the whole
  output.
- `group_norm`: GroupNorm's moments summed over the group; `mean_hw`, a
  whole map's mean (the squeeze-excite and split-attention pools).
- `gather_rows`: a band made whole on every rank, whose backward only
  slices: for tensors whose gradient is alike on every rank (the tokens
  into the LSTT, whose entry sums the ranks' parts), and for values
  without gradient (the per-pixel losses' threshold, the prediction).
  `scatter_rows`: a rank's band of a tensor alike on every rank, whose
  backward gathers (the LSTT's outputs into the decoder).

A model's methods band their maps while `banded(bands)` is entered; the
training engine enters it around each call of the model, inside the
checkpointed functions, so a recompute bands alike. Every rank runs the
same exchanges in the same order, recomputes included. `STATS` counts the
exchanges and gathers and the bytes this rank sends into them.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.parallel import dist
from rmem_ocu_tpu_torch.parallel.dist import World, all_reduce_sum
from rmem_ocu_tpu_torch.parallel.layers import scatter_to_model

GRID_STRIDE = 16
STRIDES = (1, 2, 4, 8, 16)
# the encoders whose every convolution, pool and window is banded
ENCODERS = ('resnet50', 'resnet101', 'mobilenetv2', 'mobilenetv3',
            'resnest50', 'resnest101', 'resnet50_topdown', 'swin_base')
# the parameters used band-locally: a rank's gradient is its band's part
BAND_LOCAL = ('encoder', 'decoder', 'encoder_projector',
              'patch_wise_id_bank')

STATS = {'halo': 0, 'halo_bytes': 0, 'gather': 0, 'gather_bytes': 0}
# a map's (stride, whole rows), where its width names no stride
Rows = Tuple[int, int]


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def check_model(cfg) -> None:
    """Raise unless the model's encoder runs banded."""
    if cfg.encoder not in ENCODERS:
        raise NotImplementedError(
            f'train_spatial_sharding=True with encoder {cfg.encoder!r}: '
            f'bands are ported for {", ".join(ENCODERS)}')


@dataclass(frozen=True)
class Bands:
    """The bands of an image of `size` (H, W) over the model group
    `world`: `starts[r]` is rank r's first pixel row, `starts[M]` H."""
    world: World
    size: Tuple[int, int]
    starts: Tuple[int, ...]

    def whole_rows(self, stride: int) -> int:
        return -(-self.size[0] // stride)

    def rows(self, stride: int, rank: Optional[int] = None,
             whole: Optional[int] = None) -> Tuple[int, int]:
        """(first, end) rows of rank's band (this rank's by default) of
        the map at `stride` whose whole holds `whole` rows (by default
        ceil(H / stride))."""
        r = self.world.rank if rank is None else rank
        if r < self.world.size - 1:
            return self.starts[r] // stride, self.starts[r + 1] // stride
        return (self.starts[r] // stride,
                self.whole_rows(stride) if whole is None else whole)

    def level(self, width: int) -> int:
        """The stride of a map (or a row-major [..., rows, W] tensor) of
        `width` columns."""
        for s in STRIDES:
            if -(-self.size[1] // s) == width:
                return s
        raise ValueError(f'a width of {width} is no stride of a '
                         f'{self.size} image')

    def check_halo(self, stride: int, top, bottom, what: str,
                   whole: Optional[int] = None, wrap: bool = False
                   ) -> None:
        """Raise when a halo needs more rows than a neighbour holds. top
        and bottom are one count for every rank or a count for each;
        `wrap` makes the first and the last rank neighbours."""
        m = self.world.size
        tops, bottoms = _per_rank(top, m), _per_rank(bottom, m)
        n = [e - s for s, e in (self.rows(stride, r, whole)
                                for r in range(m))]
        for r in range(m):
            up, down = _neighbours(r, m, wrap)
            if (up is not None and tops[r] > n[up]) or (
                    down is not None and bottoms[r] > n[down]):
                held = lambda k: '-' if k is None else n[k]
                raise ValueError(
                    f'{what} at stride {stride}: a halo of {tops[r]} rows '
                    f'above and {bottoms[r]} below on rank {r}, whose '
                    f'neighbours hold {held(up)} and {held(down)} rows; '
                    f'the bands {n} are too thin for a model group of {m}')


def make_bands(size, world: World) -> Bands:
    """The bands of an image of `size` (H, W) over the model group
    `world`. Raises when a band would be empty or a width would name two
    strides."""
    h, w = int(size[0]), int(size[1])
    m = world.size
    grid = -(-h // GRID_STRIDE)
    if grid < m:
        raise ValueError(f'{h} px make {grid} rows of the 16x grid: a model '
                         f'group of {m} would leave a band empty')
    if len({-(-w // s) for s in STRIDES}) < len(STRIDES):
        raise ValueError(f'a width of {w} px does not name each stride')
    starts, at = [], 0
    for r in range(m):
        starts.append(at * GRID_STRIDE)
        at += grid // m + (r < grid % m)
    return Bands(world=world, size=(h, w), starts=tuple(starts) + (h,))


_ACTIVE = threading.local()


@contextlib.contextmanager
def banded(bands: Optional[Bands]):
    """Band the maps of the enclosed model calls (nothing when None)."""
    prev = getattr(_ACTIVE, 'bands', None)
    _ACTIVE.bands = bands
    try:
        yield
    finally:
        _ACTIVE.bands = prev


def current() -> Optional[Bands]:
    return getattr(_ACTIVE, 'bands', None)


# ------------------------------------------------------------ exchange
def _exchange(world: World, sends, recvs) -> None:
    """Send each (tensor, model rank) and receive into each (buffer, model
    rank), all at once. gloo sends host memory only: CUDA tensors go
    through host copies."""
    group = world.group
    stage = (bool(sends or recvs) and (sends or recvs)[0][0].is_cuda
             and tdist.get_backend(group) == 'gloo')
    host = lambda t: t.cpu() if stage else t
    sends = [(host(t.contiguous()), r) for t, r in sends]
    inbox = [(host(b), b, r) for b, r in recvs]
    ops = [tdist.P2POp(tdist.isend, t, tdist.get_global_rank(group, r),
                       group) for t, r in sends]
    ops += [tdist.P2POp(tdist.irecv, t, tdist.get_global_rank(group, r),
                        group) for t, _, r in inbox]
    if not ops:
        return
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    if stage:
        for t, b, _ in inbox:
            b.copy_(t)
    STATS['halo'] += 1
    STATS['halo_bytes'] += sum(t.numel() * t.element_size() for t, _ in sends)


def _fill_rows(x: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    shape = list(x.shape)
    shape[-2] = n
    return x.new_full(shape, fill)


def _per_rank(n, m: int) -> Tuple[int, ...]:
    return tuple(int(k) for k in n) if isinstance(n, (tuple, list)) else (
        int(n),) * m


def _neighbours(r: int, m: int, wrap: bool):
    """(the rank above r, the rank below r), None at the image's edge; with
    the wrap the first and the last rank are each other's neighbours."""
    up = r - 1 if r > 0 else (m - 1 if wrap else None)
    down = r + 1 if r < m - 1 else (0 if wrap else None)
    return up, down


class _HaloRows(torch.autograd.Function):
    # Two ranks may swap two messages each way (M = 2 with the wrap: the
    # rank above is the rank below). gloo and NCCL match the messages of a
    # pair in the order they are posted, so both sides post them alike:
    # first the rows the receiver puts below its band, then those it puts
    # above; in the backward first the gradient of the receiver's last
    # rows, then that of its first rows.
    @staticmethod
    def forward(ctx, x, tops, bottoms, world, fill, edge, wrap):
        r = world.rank
        up, down = _neighbours(r, world.size, wrap)
        n = x.shape[-2]
        above = (_fill_rows(x, edge[0], fill) if up is None
                 else _fill_rows(x, tops[r], 0.0))
        below = (_fill_rows(x, edge[1], fill) if down is None
                 else _fill_rows(x, bottoms[r], 0.0))
        sends, recvs = [], []
        if up is not None and bottoms[up]:
            sends.append((x[..., :bottoms[up], :], up))
        if down is not None and tops[down]:
            sends.append((x[..., n - tops[down]:, :], down))
        if down is not None and bottoms[r]:
            recvs.append((below, down))
        if up is not None and tops[r]:
            recvs.append((above, up))
        _exchange(world, sends, recvs)
        ctx.args = (tops, bottoms, world, up, down, above.shape[-2], n)
        return torch.cat([above, x, below], dim=-2)

    @staticmethod
    def backward(ctx, grad):
        # each halo row's gradient goes back to the rank that owns the
        # row and adds to it there
        tops, bottoms, world, up, down, n_above, n = ctx.args
        r = world.rank
        gx = grad[..., n_above:n_above + n, :].clone(
            memory_format=torch.contiguous_format)
        sends, recvs = [], []
        from_above = from_below = None
        if up is not None and tops[r]:
            sends.append((grad[..., :tops[r], :], up))
        if down is not None and bottoms[r]:
            sends.append((grad[..., n_above + n:, :], down))
        if down is not None and tops[down]:
            from_below = _fill_rows(gx, tops[down], 0.0)
            recvs.append((from_below, down))
        if up is not None and bottoms[up]:
            from_above = _fill_rows(gx, bottoms[up], 0.0)
            recvs.append((from_above, up))
        _exchange(world, sends, recvs)
        if from_above is not None:
            gx[..., :bottoms[up], :] += from_above
        if from_below is not None:
            gx[..., n - tops[down]:, :] += from_below
        return gx, None, None, None, None, None, None


def halo_rows(x: torch.Tensor, top, bottom, world: World,
              fill: float = 0.0, edge: Optional[Tuple[int, int]] = None,
              wrap: bool = False) -> torch.Tensor:
    """x, a band of rows (dim -2), with the last `top` rows of the rank
    above on top and the first `bottom` rows of the rank below beneath.
    top and bottom are one count for every rank or a count for each rank
    (what that rank receives). At the image's edge (rank 0's top, the last
    rank's bottom) `edge` rows of `fill` (default: rank 0's top and the
    last rank's bottom); with `wrap` (a roll of the rows) rank 0's rows
    above are the last rank's last rows and the last rank's rows below
    rank 0's first rows instead."""
    m = world.size
    tops, bottoms = _per_rank(top, m), _per_rank(bottom, m)
    edge = (tops[0], bottoms[-1]) if edge is None else tuple(edge)
    return _HaloRows.apply(x, tops, bottoms, world, fill, edge, wrap)


def window_halos(bands: Bands, stride: int, hp: int, ws: int, shift: int
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The window plan of a map at `stride` padded at the bottom to `hp`
    rows (whole windows of `ws` rows that start at rows ws k + shift,
    modulo hp; the last rank's band holds the pad rows): for each rank the
    rows of halo above and below that complete the windows meeting its
    band (tops, bottoms). With a shift rank 0's windows reach up into the
    last rows and the last rank's down into the first (the roll's
    wrap)."""
    tops, bottoms = [], []
    for r in range(bands.world.size):
        first, end = bands.rows(stride, r, hp)
        tops.append((first - shift) % ws)
        bottoms.append(ws - 1 - (end - 1 - shift) % ws)
    return tuple(tops), tuple(bottoms)


def window_rows(x: torch.Tensor, bands: Bands, stride: int, hp: int,
                ws: int, shift: int, what: str) -> Tuple[torch.Tensor, int]:
    """(x with the rows that complete the windows meeting its band, the
    whole padded map's row of its first row, negative where it wraps) for
    x [..., rows, X], this rank's band (rows at dim -2) of a map at
    `stride` padded to `hp` rows, windows as `window_halos`. The halo is
    each rank's own; it wraps when the windows are shifted. Raises, naming
    `what`, where a band is thinner than the halo a neighbour takes."""
    tops, bottoms = window_halos(bands, stride, hp, ws, shift)
    bands.check_halo(stride, tops, bottoms, what, hp, wrap=shift > 0)
    x = halo_rows(x, tops, bottoms, bands.world, wrap=shift > 0)
    return x, bands.rows(stride, None, hp)[0] - tops[bands.world.rank]


# ------------------------------------------------------------- layers
def conv2d(conv: nn.Conv2d, x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """conv's output rows of this rank's band, from x, the input's band:
    p rows of halo above, d (k - 1) - p - s + 1 below (none when the
    stride skips past them), the conv's zero padding at the image's edge."""
    k, s, p, d = (conv.kernel_size[0], conv.stride[0], conv.padding[0],
                  conv.dilation[0])
    top, bottom = p, max(d * (k - 1) - p - s + 1, 0)
    bands.check_halo(bands.level(x.shape[-1]), top, bottom,
                     f'a {k}x{k} conv')
    x = halo_rows(x, top, bottom, bands.world, 0.0, edge=(p, p))
    return F.conv2d(x, conv.weight, conv.bias, conv.stride,
                    (0, conv.padding[1]), conv.dilation, conv.groups)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs on its band of rows under `banded` (the
    encoders' and the decoder's convolutions larger than 1x1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bands = current()
        return super().forward(x) if bands is None else conv2d(self, x,
                                                                bands)


def max_pool_3x3_s2(x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """The 3x3 / stride-2 / pad-1 max pool of a band: one row of halo
    above, -inf at the image's edge."""
    bands.check_halo(bands.level(x.shape[-1]), 1, 0, 'the max pool')
    x = halo_rows(x, 1, 0, bands.world, float('-inf'), edge=(1, 1))
    return F.max_pool2d(x, 3, 2, (0, 1))


def avg_pool_3x3(x: torch.Tensor, stride: int, bands: Bands
                 ) -> torch.Tensor:
    """F.avg_pool2d(x, 3, stride, 1) of a band, count_include_pad: one row
    of halo above and 2 - stride below, zero rows at the image's edge
    (counted, as the padding is)."""
    bottom = max(2 - stride, 0)
    bands.check_halo(bands.level(x.shape[-1]), 1, bottom, 'the avg pool')
    x = halo_rows(x, 1, bottom, bands.world, 0.0, edge=(1, 1))
    return F.avg_pool2d(x, 3, stride, (0, 1))


def check_windows(x: torch.Tensor, stride: int, bands: Bands,
                  what: str) -> None:
    """Raise unless every band of x's map starts on a window of a
    stride x stride pool and every band but the last ends on one, so that
    no window crosses two bands (the last one's partial window at the
    bottom edge is the whole map's)."""
    s = bands.level(x.shape[-1])
    for r in range(bands.world.size):
        first, end = bands.rows(s, r)
        if first % stride or (r < bands.world.size - 1 and end % stride):
            raise ValueError(f'{what}: rank {r}\'s band [{first}, {end}) '
                             f'of the map at stride {s} splits a window '
                             f'of {stride} rows')


def transposed_rows(conv: nn.ConvTranspose2d, at: Optional[Rows]
                    ) -> Optional[Rows]:
    """(stride, whole rows) of the map that conv makes from the map `at`
    (None stays None)."""
    if at is None:
        return None
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    stride, n = at
    if stride % s:
        raise ValueError(f'a stride-{s} transposed conv of the map at '
                         f'stride {stride}')
    return stride // s, s * (n - 1) - 2 * p + k + conv.output_padding[0]


def conv_transpose2d(conv: nn.ConvTranspose2d, x: torch.Tensor,
                     bands: Bands, at: Rows) -> torch.Tensor:
    """conv's output rows of this rank's band, from x, this rank's band of
    the map `at` (stride, whole rows). An output band [o0, o1) reads the
    input rows ceil((o0 + p - k + 1) / s) to floor((o1 - 1 + p) / s):
    the band takes them as halo (the most any rank needs, zeros past the
    image's edge, where no input row exists), runs without row padding
    and keeps the rows [o0, o1) of the whole output."""
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    if conv.dilation[0] != 1:
        raise NotImplementedError('a dilated banded transposed conv')
    out = transposed_rows(conv, at)
    top = bottom = 0
    for r in range(bands.world.size):
        a0, a1 = bands.rows(at[0], r, at[1])
        o0, o1 = bands.rows(out[0], r, out[1])
        top = max(top, a0 - -(-(o0 + p - k + 1) // s))
        bottom = max(bottom, (o1 - 1 + p) // s - (a1 - 1))
    bands.check_halo(at[0], top, bottom, f'a {k}x{k} transposed conv',
                     at[1])
    x = halo_rows(x, top, bottom, bands.world)
    y = F.conv_transpose2d(x, conv.weight, conv.bias, conv.stride,
                           (0, conv.padding[1]),
                           (0, conv.output_padding[1]), conv.groups)
    a0 = bands.rows(at[0], None, at[1])[0]
    o0, o1 = bands.rows(out[0], None, out[1])
    first = o0 + p - (a0 - top) * s
    if first < 0 or first + o1 - o0 > y.shape[-2]:
        raise ValueError(f'rows [{o0}, {o1}) of a {k}x{k} transposed conv '
                         f'lie past its band\'s output')
    return y[..., first:first + o1 - o0, :]


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d that runs on its band of rows under `banded`,
    where `at`, the (stride, whole rows) of the input's map, is given."""

    def forward(self, x: torch.Tensor, at: Optional[Rows] = None
                ) -> torch.Tensor:
        bands = current()
        if bands is None:
            return super().forward(x)
        return conv_transpose2d(self, x, bands, at)


def group_norm(x: torch.Tensor, gn: nn.GroupNorm, bands: Bands
               ) -> torch.Tensor:
    """GroupNorm of a band by the whole map's moments (f32, or f64 on f64
    inputs): the sums of each (sample, group) and then of its squared
    deviations over the group, by a differentiable all-reduce whose
    backward sums (each rank's normalisation of its band feeds its own
    work)."""
    n, c = x.shape[:2]
    g = gn.num_groups
    xf = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(n, g, -1)
    w = x.shape[-1]
    count = c // g * bands.whole_rows(bands.level(w)) * w
    mean = all_reduce_sum(xf.sum(-1), bands.world) / count
    dev = xf - mean[..., None]
    var = all_reduce_sum(dev.square().sum(-1), bands.world) / count
    y = (dev * torch.rsqrt(var + gn.eps)[..., None]).reshape(x.shape)
    y = y * gn.weight.to(y.dtype)[:, None, None] + gn.bias.to(y.dtype)[
        :, None, None]
    return y.to(x.dtype)


def mean_hw(x: torch.Tensor, bands: Bands, keepdim: bool = False
            ) -> torch.Tensor:
    """The whole map's mean over rows and columns of which x [..., rows,
    W] is a band (f32, or f64 on f64 inputs): the band's sums, summed
    over the group by a differentiable all-reduce whose backward sums
    (each rank's use of the mean feeds its own work), over the whole
    map's count."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    w = x.shape[-1]
    total = all_reduce_sum(xf.sum(dim=(-2, -1), keepdim=keepdim),
                           bands.world)
    return (total / (bands.whole_rows(bands.level(w)) * w)).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, first, whole):
        ctx.args = (first, x.shape[-2])
        return dist.all_gather(x, world, ((first, x.shape[-2]),), whole, -2)

    @staticmethod
    def backward(ctx, grad):
        first, n = ctx.args
        return grad.narrow(-2, first, n), None, None, None


def gather_rows(x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """The whole map (alike on every rank) of which x is this rank's band:
    one all-reduce of a zero-filled buffer. Its backward only slices, so
    the whole's gradient must be alike on every rank."""
    s = bands.level(x.shape[-1])
    first, _ = bands.rows(s)
    whole = bands.whole_rows(s)
    STATS['gather'] += 1
    STATS['gather_bytes'] += x.numel() // x.shape[-2] * whole * \
        x.element_size()
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, bands.world, first, whole)
    return dist.all_gather(x, bands.world, ((first, x.shape[-2]),), whole,
                           -2)


def scatter_rows(x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """This rank's band of x, a map alike on every rank; the backward
    gathers the ranks' gradients (scatter_to_model)."""
    first, end = bands.rows(bands.level(x.shape[-1]))
    return scatter_to_model(x, bands.world, ((first, end - first),), -2)
