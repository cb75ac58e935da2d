"""The frozen reference agrees with the port on the CPU (float32, tiny
frames, full widths and depths): the same seeded weights, the same clips,
the reference following the port's masks and evictions."""
import pytest
import torch

from rmembench import program, traffic
from rmembench.reference.model import DeAOTReference
from rmembench.reference.stream import ReferenceStream
from rmembench.testutil import tiny_cell
from rmembench.weights import seeded_weights

# the port's float32 path rounds the bank read's operands to bf16 (its
# kernel's arithmetic); that puts its logits within ~5e-4 of the
# reference's at these sizes
LOGIT_TOL = 2e-3


def _drive(workload, perturb=None, frames=12):
    torch.manual_seed(0)
    cell = tiny_cell(workload)
    config = dict(cell['config'], compute_dtype='float32')
    mc = config['model']
    exp, model = program.build_model(config, 'cpu')
    weights = seeded_weights(program.shapes_of(model), 3, 'cpu',
                             torch.float32)
    model.load_state_dict(weights)
    size = traffic.input_size(cell['traffic'], mc['align_corners'])
    clips = traffic.Clips(cell['traffic'], size, 4, 'cpu')
    eng = program.engine(model, exp, 1)
    state = eng.init_state(2, program.grid_of(size, mc['align_corners']))
    state = eng.add_reference_frame(state, clips.pool[0], clips.label0,
                                    torch.full((2,), 3))
    ref_w = dict(weights)
    if perturb is not None:
        ref_w[perturb] = ref_w[perturb] * 1.01
    ref = ReferenceStream(DeAOTReference(ref_w, mc), 3, 1)
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


@pytest.mark.parametrize('workload', ['r50_deaotl.vost_b8',
                                      'swinb_deaotl.vost_b8'])
def test_reference_agrees_with_the_port(workload):
    assert _drive(workload) < LOGIT_TOL


def test_a_one_percent_weight_change_fails_the_tolerance():
    assert _drive('r50_deaotl.vost_b8',
                  perturb='LSTT.layers.1.linear_QV.weight', frames=3) \
        > LOGIT_TOL
