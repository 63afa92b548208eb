"""The plain reference (portbench/reference) held to satae_torch at tiny
widths on the CPU: the served logits, the augmentation and its frozen draw
order, and three training steps with Adam. CPU only."""

import pytest
import torch

from portbench import inputs
from portbench.reference import model as R
from portbench.reference import precision as P

TINY = {"latent_dim": 8, "encoder_channels": [4, 8], "head_hidden": 16,
        "mlp_hidden": [16, 8], "mlp_dropout": 0.3, "num_classes": 10,
        "bn_momentum": 0.1, "bn_eps": 1e-5}
SIZE, CH = 16, 3
DATA = {"image_size": SIZE, "channels": CH, "crop_padding": 4,
        "noise_std": 0.03}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    from satae_torch import config as C

    return C.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in TINY.items()})


def _images(n, seed=5):
    return inputs.images(n, SIZE, CH, 10,
                         inputs.generator(seed, "cpu", 1), "cpu")


def test_shapes_are_the_programs_state_dicts():
    from satae_torch.models.mlp import MLP
    from satae_torch.models.supervised_ae import SupervisedAE

    ae = SupervisedAE(_cfg(), CH, SIZE).state_dict()
    assert [(k, tuple(v.shape)) for k, v in ae.items()] == \
        [(k, s) for k, s, _ in R.ae_shapes(TINY, SIZE, CH)]
    mlp = MLP(_cfg()).state_dict()
    assert [(k, tuple(v.shape)) for k, v in mlp.items()] == \
        [(k, s) for k, s, _ in R.mlp_shapes(TINY)]
    assert R.trainable(R.ae_shapes(TINY, SIZE, CH)) == \
        [k for k, _ in SupervisedAE(_cfg(), CH, SIZE).named_parameters()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_logits_match_the_programs(dtype):
    from satae_torch.data.augment import normalize
    from satae_torch.models import fast_infer
    from satae_torch.models.mlp import MLP
    from satae_torch.models.supervised_ae import SupervisedAE

    imgs, _ = _images(300)
    ae_p, mlp_p = inputs.served_models(TINY, SIZE, CH, imgs[:128],
                                       inputs.generator(5, "cpu", 2))
    ae = SupervisedAE(_cfg(), CH, SIZE)
    ae.load_state_dict(ae_p)
    mlp = MLP(_cfg())
    mlp.load_state_dict(mlp_p)
    dt = getattr(torch, dtype)
    fe = fast_infer.fold_encoder(ae.eval().enc, dt)
    fm = fast_infer.fold_mlp(mlp.eval())
    with torch.no_grad():
        got = fast_infer.mlp_infer(fm, fast_infer.encoder_infer(
            fe, normalize(imgs, dt)).float())
    ref = R.serve_logits(ae_p, mlp_p, imgs, TINY, block=128)
    tol = 1e-4 if dtype == "float32" else 0.1
    assert (got - ref).abs().max() < tol
    assert ref.std(0).min() > 0.05  # the logits spread over the images


def test_augmentation_and_its_draws_match_the_programs():
    from satae_torch.data.augment import (augment_stacked_batch,
                                          draw_stacked_augmentation)

    imgs, _ = _images(12)
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    theirs = draw_stacked_augmentation(3, imgs.shape, 4, g1, "cpu")
    ours = R.draw_stacked(3, 12, SIZE, CH, 4, g2, "cpu", torch.float32)
    for a, b in zip(theirs, ours):
        assert torch.equal(a, b)
    x = augment_stacked_batch(imgs, *theirs, crop_padding=4, noise_std=0.03)
    for c in range(3):
        y = R.augment(imgs, ours[0][c], ours[1][c], ours[2][c], 4, 0.03)
        assert torch.allclose(x[c].permute(0, 3, 1, 2), y, atol=1e-7)


def test_three_steps_match_the_programs_step():
    """Losses, the first gradients and the parameters after three stacked AE
    steps with Adam, two configs on a shared batch: the reference, config
    by config, against satae_torch's stacked_ae_train_step on the same
    weights, batches and draws."""
    from satae_torch.config import DataConfig
    from satae_torch.models.stacked import StackedSupervisedAE
    from satae_torch.train.optim import adam_init
    from satae_torch.train.steps import stacked_ae_train_step

    hp = [(30.0, 1e-3), (20.0, 5e-3)]
    c = len(hp)
    imgs, labels = _images(48)
    shapes = R.ae_shapes(TINY, SIZE, CH)
    p0 = inputs.tensors(shapes, inputs.generator(5, "cpu", 2), "cpu",
                        configs=c)
    net = StackedSupervisedAE(_cfg(), c, CH, SIZE)
    net.load_state_dict(p0)
    opt = adam_init(list(net.parameters()))
    dc = DataConfig(image_size=SIZE, channels=CH, batch_size=16)
    alphas = torch.tensor([a for a, _ in hp])
    lrs = torch.tensor([lr for _, lr in hp])
    gen = torch.Generator().manual_seed(11)
    ref_gen = torch.Generator().manual_seed(11)
    rows, draws, losses, g1 = [], [], [], None
    for s in range(3):
        r = slice(16 * s, 16 * s + 16)
        rows.append(r)
        draws.append(R.draw_stacked(c, 16, SIZE, CH, 4, ref_gen, "cpu",
                                    torch.float32))
        metrics, grads = stacked_ae_train_step(
            net, opt, imgs[r], labels[r], alphas, lrs, dc, generator=gen)
        losses.append(metrics["loss"].clone())
        g1 = g1 or dict(zip([k for k, _ in net.named_parameters()], grads))
    losses = torch.stack(losses, 1)
    names = R.trainable(shapes)
    params = dict(net.named_parameters())
    for i, (alpha, lr) in enumerate(hp):
        batches = [(imgs[r], labels[r], tuple(t[i] for t in d))
                   for r, d in zip(rows, draws)]
        ref_losses, ref_g1, ref_p = R.train_steps(
            {k: v[i] for k, v in p0.items()}, names, batches, alpha, lr,
            TINY, DATA)
        assert ref_losses == pytest.approx(losses[i].tolist(), rel=1e-5)
        med = torch.stack([ref_g1[k].norm() for k in names]).median()
        for k in names:
            scale = max(ref_g1[k].norm(), med)
            assert (g1[k][i] - ref_g1[k]).norm() / scale < 1e-4, k
            # a leaf whose gradient is nought to rounding (a bias before a
            # train-mode BatchNorm) moves under Adam by rounding alone
            if ref_g1[k].norm() >= 1e-3 * med:
                assert torch.allclose(params[k][i].detach(), ref_p[k],
                                      atol=1e-5), k


def test_roundings():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-5,
                      123.456])
    t = P.round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 and t[2] == 1.0 + 2 ** -9
    bits = t.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()
    assert ((t - x).abs() <= x.abs() * 2 ** -11).all()
    y = torch.linspace(-3, 5, 101)
    f8 = P.round_fp8_e4m3(y)
    assert f8.abs().max() == 5.0
    assert ((f8 - y).abs() <= y.abs() * 2 ** -4 + 5 / 448 * 2 ** -9).all()
    assert not torch.equal(f8, y)
