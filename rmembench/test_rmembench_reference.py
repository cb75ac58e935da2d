"""The frozen references agree with the port on the CPU (float32, tiny
frames, full widths and depths): the same seeded weights, the same clips,
the reference following the port's masks and evictions. Each family
against the port's models of it: DeAOT's R50 and Swin-B cells, and AOT's
R50-AOT-L, which no cell runs yet."""
import pytest
import torch

from rmembench import harness, program, traffic
from rmembench.reference.stream import ReferenceStream
from rmembench.test_rmembench_families import R50_AOTL
from rmembench.testutil import tiny_cell
from rmembench.weights import seeded_weights

# the port's float32 path rounds the bank read's operands to bf16 (its
# kernel's arithmetic); that puts its logits within ~5e-4 of the
# reference's at these sizes
LOGIT_TOL = 2e-3
# R50-AOT-L's bank read rounds its operands and probabilities to bf16 in
# the same way: its logits lie within 1.6e-4 of the reference's here,
# while a 1% change of one layer's query projection moves them by 5.2e-4
AOT_LOGIT_TOL = 3e-4


def _config(name):
    if name == 'r50_aotl':
        return R50_AOTL, tiny_cell()['traffic']
    if name == 'r50_aotl.linear_q':
        # the stages outside VOST join the previous frame's keys and values
        # to the current frame's in the short-term read
        model = dict(R50_AOTL['model'], linear_q=True)
        return dict(R50_AOTL, stage='pre', model=model), \
            tiny_cell()['traffic']
    cell = tiny_cell(f'{name}.vost_b8')
    return cell['config'], cell['traffic']


def _drive(name, perturb=None, frames=12):
    """The largest logit gap to the port over `frames` frames at gap 1
    (a write every frame, the bank over budget from frame 9 on); the bank
    ids and each eviction are held equal on the way."""
    torch.manual_seed(0)
    config, tr = _config(name)
    config = dict(config, compute_dtype='float32')
    mc = config['model']
    exp, model = program.build_model(config, 'cpu')
    weights = seeded_weights(program.shapes_of(model), 3, 'cpu',
                             torch.float32)
    model.load_state_dict(weights)
    size = traffic.input_size(tr, mc['align_corners'])
    clips = traffic.Clips(tr, size, 4, 'cpu')
    eng = program.engine(model, exp, 1)
    state = eng.init_state(2, program.grid_of(size, mc['align_corners']))
    state = eng.add_reference_frame(state, clips.pool[0], clips.label0,
                                    torch.full((2,), 3))
    ref_w = dict(weights)
    if perturb is not None:
        ref_w[perturb] = ref_w[perturb] * 1.01
    family = harness.load_family(config)
    ref = ReferenceStream(family.Reference(ref_w, mc), 3, 1)
    ref.start(clips.pool[0], clips.label0)
    worst, evictions = 0.0, 0
    for t in range(1, frames + 1):
        img = clips.pool[traffic.ping_pong(t, clips.n_frames)]
        logits, state = eng.propagate(state, img)
        ref_logits = ref.propagate(img)
        worst = max(worst, float((ref_logits[:, :4]
                                  - logits.permute(0, 3, 1, 2)[:, :4])
                                 .abs().max()))
        pred = eng.predict_mask(logits, size)
        state = eng.update_memory(state, pred)
        write = ref.update(pred)
        held = [set(r.tolist()) - {-1} for r in state.bank.frame_ids]
        if write is None or not write['over']:
            ids = ref.frame_ids if write is None else write['frame_ids']
            assert held == [set(r.tolist()) for r in ids]
            continue
        rows = write['frame_ids'].tolist()
        drops = [row.index((set(row) - h).pop()) for row, h in
                 zip(rows, held)]
        assert drops == write['score'].argmin(1).tolist()
        ref.evict(torch.tensor(drops))
        evictions += 1
    assert evictions >= frames - 9
    return worst


@pytest.mark.parametrize('name', ['r50_deaotl', 'swinb_deaotl'])
def test_reference_agrees_with_the_port(name):
    assert _drive(name) < LOGIT_TOL


def test_a_one_percent_weight_change_fails_the_tolerance():
    assert _drive('r50_deaotl', perturb='LSTT.layers.1.linear_QV.weight',
                  frames=3) > LOGIT_TOL


@pytest.mark.parametrize('name', ['r50_aotl', 'r50_aotl.linear_q'])
def test_the_aot_reference_agrees_with_the_port(name):
    assert _drive(name) < AOT_LOGIT_TOL


def test_a_one_percent_weight_change_fails_the_aot_tolerance():
    assert _drive('r50_aotl', perturb='LSTT.layers.1.linear_Q.weight',
                  frames=3) > AOT_LOGIT_TOL
