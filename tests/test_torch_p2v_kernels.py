"""(E)Pix2Vox's 128^3 tail kernels (``ops/kernels/p2v_tail.py``,
``csrc/p2v_tail.cu``): the merger's conv + batch norm + leaky-ReLU blocks and
up5's weight gradient.

On the CPU the autograd functions run on each kernel's plain version, held here
against the library's path (``nn.Conv3d`` + ``BatchNorm`` + ``leaky_relu``, and
``nn.ConvTranspose3d``), and on a 'data' group of two gloo ranks against the
whole batch on one; the model's route is checked to refuse CPU tensors, float64
twins and the 'model' axis's stand-ins. The tests marked ``cuda`` hold the
kernels against the library run in float64 on the card, at the merger's full
shapes and at an odd small shape, and on two ranks sharing the card against one,
and run without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_p2v_kernels.py
"""

import copy
from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import torch_mesh_workers as workers
from acquisition_focus_tpu_torch.models.epix2vox import (
    BatchNorm, EPix2VoxModel128, Epix2VoxDecoder, Epix2VoxMerger, MergerConv, _tail_on_card,
    _whole, init_weights)
from acquisition_focus_tpu_torch.ops.channel_ops import channel_softmax, channel_sum
from acquisition_focus_tpu_torch.ops.kernels import _lib, p2v_tail
from acquisition_focus_tpu_torch.parallel.mesh import spawn_ranks

SLOPE = 0.2
P2V_KERNELS = ('p2v_merge_fwd', 'p2v_merge_dx', 'p2v_merge_dw', 'p2v_merge_norm',
               'p2v_merge_sum', 'p2v_up_dw')


def _merger(seed, dtype=torch.float32, device='cpu', slope=SLOPE):
    """A merger with random norm scales and shifts and nonzero biases, so every
    term of the norms' backward is exercised."""
    torch.manual_seed(seed)
    m = Epix2VoxMerger(slope)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith('_bn.weight'):
                p.uniform_(0.5, 1.5)
            elif name.endswith('bias'):
                p.normal_(0.0, 0.3)
    return m.to(device=device, dtype=dtype)


def _library_blocks(m, x, masks=None):
    """Today's path: each block through the modules as ``nn.Conv3d`` calls;
    ``masks``: each leaky-ReLU's branch (z > 0) given, not taken from z."""
    for i in range(len(m.FEATURES)):
        conv, norm = getattr(m, f'm{i}_conv'), getattr(m, f'm{i}_bn')
        z = norm(F.conv3d(x, conv.weight, conv.bias, padding=1))
        x = F.leaky_relu(z, m.leaky) if masks is None else torch.where(masks[i], z, z * m.leaky)
    return x


def _blocks(m):
    n = len(m.FEATURES)
    return ([getattr(m, f'm{i}_conv') for i in range(n)],
            [getattr(m, f'm{i}_bn') for i in range(n)])


def _grads_of(fn, m, x, g):
    x = x.detach().clone().requires_grad_()
    m.zero_grad()
    out = fn(m, x)
    out.backward(g)
    return out.detach(), x.grad, {n: p.grad.clone() for n, p in m.named_parameters()}


def _fused(m, x):
    return p2v_tail.merge_convs(x, *_blocks(m), m.leaky)


def _max_rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize('shape', [(2, 9, 5, 6, 7), (1, 9, 4, 4, 4)])
def test_fused_blocks_plain_match_the_library_path(shape):
    """The block-by-block functions on their plain versions (the norm folded
    into the next conv's input, its backward as dy = k dz + al y + be) against
    the library's autograd, in float64: output, input gradient and every
    parameter's gradient. The conv biases' gradients are rounding under the
    norms (exactly 0 in exact arithmetic), so they are held to the scale of the
    weights' gradients."""
    m = _merger(0, torch.float64)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    g = torch.randn((shape[0], 1) + shape[2:], generator=gen, dtype=torch.float64)
    ref = _grads_of(_library_blocks, m, x, g)
    got = _grads_of(_fused, m, x, g)
    assert _max_rel(got[0], ref[0]) < 1e-12
    assert _max_rel(got[1], ref[1]) < 1e-10
    for name, r in ref[2].items():
        scale = ref[2][name.replace('bias', 'weight')].abs().max() if '_conv.bias' in name else None
        err = (got[2][name] - r).abs().max() / (scale if scale is not None else r.abs().max())
        assert err < 1e-10, name


@pytest.mark.parametrize('ci, co', [(32, 8), (16, 4)])
def test_up_conv_plain_matches_the_module(ci, co):
    """up5's function on the plain weight gradient against ``nn.ConvTranspose3d``:
    the forward and the input gradient are the same library calls (equal bits),
    the weight gradient the same sums; any widths on the CPU."""
    torch.manual_seed(0)
    conv = nn.ConvTranspose3d(ci, co, 4, stride=2, padding=1, bias=False).double()
    x = torch.randn(2, ci, 3, 4, 5, dtype=torch.float64)
    g = torch.randn(2, co, 6, 8, 10, dtype=torch.float64)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = conv(xa)
    ya.backward(g)
    wa = conv.weight.grad.clone()
    conv.weight.grad = None
    yb = p2v_tail.up_conv(xb, conv.weight)
    yb.backward(g)
    assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad)
    assert _max_rel(conv.weight.grad, wa) < 1e-12


def test_route_takes_cuda_float32_whole_modules_only():
    """The kernels run for CUDA float32 tensors on the model's own modules,
    whatever their norms' group; a stand-in of the 'model' axis keeps the
    library's path and says so."""
    m = _merger(0)
    convs, norms = _blocks(m)
    types = [MergerConv] * 5 + [BatchNorm] * 5
    assert _tail_on_card(SimpleNamespace(is_cuda=True, dtype=torch.float32))
    assert not _tail_on_card(torch.zeros(1))
    assert not _tail_on_card(SimpleNamespace(is_cuda=True, dtype=torch.float64))
    assert _whole('merger', convs + norms, types)
    stand_in = copy.deepcopy(convs)
    stand_in[1] = nn.Conv3d(16, 8, 3, padding=1)
    with pytest.warns(UserWarning, match="stand-ins keep the library's path"):
        assert not _whole('merger', stand_in + norms, types)


def test_cpu_model_keeps_the_library_path_bit_for_bit(monkeypatch):
    """On the CPU neither the merger nor up5 reaches the tail's functions, the
    merger's output is today's bits, and nothing is launched."""
    def refuse(*args, **kwargs):
        raise AssertionError("the tail's route was taken on the CPU")
    monkeypatch.setattr(p2v_tail, 'merge_convs', refuse)
    monkeypatch.setattr(p2v_tail, 'up_conv', refuse)
    _lib.reset_launch_counts()
    m = _merger(3)
    gen = torch.Generator().manual_seed(2)
    raw = torch.randn(1, 2, 9, 6, 6, 6, generator=gen)
    coarse = torch.rand(1, 2, 6, 6, 6, generator=gen)
    got = m(raw, coarse)
    x = _library_blocks(m, raw.reshape(2, 9, 6, 6, 6))
    w = channel_softmax(x.reshape(1, 2, 6, 6, 6))
    assert torch.equal(got, torch.clamp(channel_sum(coarse * w, keepdims=False), 0.0, 1.0))
    dec = Epix2VoxDecoder(in_features=16, features=(8, 32, 8))
    dec(torch.randn(1, 1, 8, 8, 1, generator=gen)[..., :1].expand(1, 1, 8, 8, 2))
    assert all(_lib.LAUNCHES[k] == 0 for k in P2V_KERNELS)


def test_merger_modules_keep_their_names_and_init():
    """``MergerConv`` is an ``nn.Conv3d``: the same parameter names and shapes,
    and ``init_weights`` draws them as before."""
    model = EPix2VoxModel128(2)
    names = {n: tuple(p.shape) for n, p in model.merger.named_parameters()}
    assert names['m0_conv.weight'] == (16, 9, 3, 3, 3) and names['m4_conv.bias'] == (1,)
    assert all(isinstance(getattr(model.merger, f'm{i}_conv'), nn.Conv3d) for i in range(5))
    init_weights(model, torch.Generator().manual_seed(0))
    assert not model.merger.m0_conv.bias.detach().any()


def _data_group_case(seed, dtype, slope, shape):
    m = _merger(seed, dtype, slope=slope)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(shape, generator=gen, dtype=dtype)
    g = torch.randn((shape[0], 1) + shape[2:], generator=gen, dtype=dtype)
    return m, x, g


def _on_data_group(tmp_path, m, x, g, device, ranks=2):
    """``merge_convs`` on {'data': ranks}, each rank on its rows (gloo; a CUDA
    ``device`` is shared by the ranks)."""
    state = {k: v.cpu() for k, v in m.state_dict().items()}
    job = ('merger_data_group', state, m.leaky, x.cpu(), g.cpu(), ranks, device)
    spawn_ranks(workers.world, ranks, args=([job], str(tmp_path)), backend='gloo', threads=1)
    return torch.load(tmp_path / '0.pt', weights_only=False)


def test_data_group_plain_matches_the_whole_batch(tmp_path):
    """The plain versions on two gloo ranks, each on half the batch with its
    norms' statistics summed over 'data', against one process on the whole
    batch, in float64: the output, the input gradient, and every parameter's
    gradient summed over the ranks (the ranks' sums of the partials in another
    order: rounding alone)."""
    m, x, g = _data_group_case(4, torch.float64, SLOPE, (4, 9, 4, 5, 6))
    out, dx, grads = _grads_of(_fused, m, x, g)
    got = _on_data_group(tmp_path, m, x, g, 'cpu')
    assert _max_rel(got['out'], out) < 1e-12
    assert _max_rel(got['dx'], dx) < 1e-10
    for name, r in grads.items():
        scale = grads[name.replace('bias', 'weight')].abs().max() if '_conv.bias' in name else None
        err = (got['grads'][name] - r).abs().max() / (scale if scale is not None else r.abs().max())
        assert err < 1e-10, name


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _card_case(shape, cuda, seed=0):
    m = _merger(seed, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    x = torch.randn(shape, generator=gen, device=cuda)
    g = torch.randn((shape[0], 1) + shape[2:], generator=gen, device=cuda)
    return m, x, g


def _kernel_masks(m, x):
    """Each block's leaky-ReLU branch (z > 0) as the kernels take it: z is
    fma(y, scale, shift) in float32 from the block's pre-norm output y and its
    statistics in every kernel, ``p2v_merge_norm``'s activation among them."""
    convs, norms = _blocks(m)
    masks, prev = [], (None, None, None, m.leaky, None)
    with torch.no_grad():
        for conv, norm in zip(convs, norms):
            x, st = conv(x, prev, norm)
            masks.append(p2v_tail.norm_act(x, st, norm.weight, norm.bias, m.leaky) > 0)
            prev = (st, norm.weight, norm.bias, m.leaky, None)
    return masks


def _gaps(got, ref):
    """Max error over max |ref| of the output, the input gradient and each
    parameter's gradient (a conv bias's over its weight's gradient: it is
    rounding under the norms, 0 in exact arithmetic)."""
    gaps = {}
    for k, what in ((0, 'output'), (1, 'input gradient')):
        gaps[what] = _max_rel(got[k].double().cpu(), ref[k].double().cpu())
    for name, r in ref[2].items():
        scale = ref[2][name.replace('bias', 'weight')] if '_conv.bias' in name else r
        gaps[name] = ((got[2][name].double().cpu() - r.double().cpu()).abs().max()
                      / scale.double().abs().max().cpu()).item()
    return gaps


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 9, 128, 128, 128), (4, 9, 128, 128, 128),
                                   (3, 9, 5, 11, 37)])
def test_merger_kernels_match_the_library(cuda, shape):
    """The five blocks on the kernels (float32) against the library's path
    (``F.conv3d`` + ``F.batch_norm``) run in float64 from the same weights and
    inputs, with each leaky-ReLU's branch taken from the kernels' own z: where z
    lies within float32 rounding of 0 the two would take different slopes in
    backward, and one such voxel moves the input gradient by ~1e-1 of its
    largest entry at 128^3. With the branches shared, what is left is float32
    rounding: the output and the input gradient within 1e-5 of their largest
    entry, each parameter's gradient within 5e-5 (sums over up to 8M voxels;
    a conv bias's gradient against its weight's). Measured on an H100: up to
    9.3e-7 (output), 1.0e-6 (input gradient), 5.1e-6 (a norm's scale)."""
    m, x, g = _card_case(shape, cuda)
    masks = _kernel_masks(m, x)
    ref = _grads_of(lambda mm, xx: _library_blocks(mm, xx, masks), copy.deepcopy(m).double(),
                    x.double(), g.double())
    del masks
    gaps = _gaps(_grads_of(_fused, m, x, g), ref)
    print(f"{shape}: {gaps}")
    tols = {'output': 1e-5, 'input gradient': 1e-5}
    bad = {k: v for k, v in gaps.items() if not v <= tols.get(k, 5e-5)}
    assert not bad, gaps


@pytest.mark.cuda
def test_merger_kernels_same_bits_every_run(cuda):
    """Two runs of the merger's forward and backward give the same bits."""
    m, x, g = _card_case((2, 9, 64, 64, 64), cuda, seed=5)
    a, b = _grads_of(_fused, m, x, g), _grads_of(_fused, m, x, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(a[2][n], b[2][n]) for n in a[2])


@pytest.mark.cuda
def test_merger_launches(cuda):
    """One forward and backward of the merger: 5 conv forwards, 5 weight
    gradients, 5 input gradients; the norm passes: the last block's activation,
    and a sum and an apply for each of the five norms; 5 + 5 + 5 ordered sums."""
    m, x, g = _card_case((1, 9, 16, 16, 32), cuda)
    _lib.reset_launch_counts()
    _grads_of(_fused, m, x, g)
    assert {k: _lib.LAUNCHES[k] for k in P2V_KERNELS} == {
        'p2v_merge_fwd': 5, 'p2v_merge_dx': 5, 'p2v_merge_dw': 5, 'p2v_merge_norm': 11,
        'p2v_merge_sum': 15, 'p2v_up_dw': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 32, 64, 64, 64), (3, 32, 5, 7, 19)])
def test_up_weight_grad_matches_the_library(cuda, shape):
    """``p2v_up_dw`` against the library's weight gradient of the transposed conv
    run in float64 from the same inputs, within 1e-5 of its largest entry
    (float32 sums over up to 0.5M voxels in another order), and the same bits in
    two runs."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda)
    N, _, D, H, W = shape
    g = torch.randn((N, 8, 2 * D, 2 * H, 2 * W), generator=gen, device=cuda)
    w = torch.empty(p2v_tail.UP_KERNEL_SHAPE, device=cuda, dtype=torch.float64)
    ref = torch.ops.aten.convolution_backward(g.double(), x.double(), w, None, [2] * 3,
                                              [1] * 3, [1] * 3, True, [0] * 3, 1,
                                              [False, True, False])[1]
    got = p2v_tail.up_weight_grad(x, g, w.shape)
    assert _max_rel(got.double(), ref) < 1e-5
    assert torch.equal(got, p2v_tail.up_weight_grad(x, g, w.shape))
    with pytest.raises(ValueError, match='p2v_up_dw computes'):
        p2v_tail.up_weight_grad(x, g, (32, 4, 4, 4, 4))


@pytest.mark.cuda
def test_model_routes_the_tail_on_the_card(cuda):
    """A float32 EPix2VoxModel128 step on the card launches the tail's kernels
    once per merger and up5; its float64 twin launches none."""
    model = EPix2VoxModel128(1).to(cuda)
    init_weights(model, torch.Generator().manual_seed(0))
    views = torch.rand(1, 1, 3, 224, 224, device=cuda) * 255.0
    _lib.reset_launch_counts()
    model(views).sum().backward()
    assert _lib.LAUNCHES['p2v_merge_fwd'] == 5 and _lib.LAUNCHES['p2v_up_dw'] == 1
    _lib.reset_launch_counts()
    twin = EPix2VoxModel128(1).double().to(cuda)
    twin(views.double()).sum().backward()
    assert all(_lib.LAUNCHES[k] == 0 for k in P2V_KERNELS)


@pytest.mark.cuda
def test_merger_data_group_on_the_card(cuda, tmp_path):
    """The kernels on two gloo ranks sharing the card, each on half the batch
    with its norms' partial sums summed over 'data' before their ordered sum,
    against one process on the whole batch: the output, the input gradient and
    every parameter's gradient summed over the ranks, within 1e-5 of their
    largest entry (float32 partials summed in another order; up to 3.0e-6 on an
    H100). Slope 1 makes the activation the identity, so no branch of it can
    flip between the two."""
    m, x, g = _data_group_case(6, torch.float32, 1.0, (4, 9, 16, 20, 24))
    m = m.to(cuda)
    ref = _grads_of(_fused, m, x.to(cuda), g.to(cuda))
    got = _on_data_group(tmp_path, m, x, g, 'cuda')
    gaps = _gaps((got['out'], got['dx'], got['grads']), ref)
    print(f"two ranks: {gaps}")
    assert all(v <= 1e-5 for v in gaps.values()), gaps
