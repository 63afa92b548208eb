"""Traffic kind ``ae_train``: the supervised autoencoder trained on a split
held on the device, as the grid fit trains it, eval left out.

Every config of the configuration's alpha x lr grid trains at once
(``satae_torch.train.hbm.stacked_ae_train_epoch``, the vmap engine of
``fit(grid=True)`` with ``parallel_configs``), at the configuration's
batch. Rows come from ``hbm.epoch_order`` of the seed, epoch after epoch;
a unit of work is ``unit_steps`` steps through the epoch function, then the
host reads the sums back.

Set-up builds the model, Adam and the augmentation generator once, drives
them through the first three steps by the window's own call on rows that
all differ, records what the check compares, and hands the same objects to
the window. After the window the plain reference follows the same three
steps of every config from the same weights, batches and draws, and the
check compares the first step's loss (``loss_gap``, relative; the later
steps' losses move apart by rounding at the grid's largest rates), the
first gradient as Adam got it, worked out from its first moment
(``grad_gap``), and the change of the parameters after three steps
(``step_gap``). The norms are taken per leaf and config; a gap is
|program's norm - reference's norm| over the larger of the reference's norm
of that leaf and of its median leaf, the worst over leaves and configs.
Leaves whose reference gradient is under a thousandth of the median leaf's
(the biases before a train-mode BatchNorm, whose gradient is nought but
for rounding) are left out of both norm gaps: Adam moves them by rounding
alone, and in bf16 their gradient is rounding noise.

``FAULTS``: the faults the check has to catch in this kind, planted in the
program by the tests of ``portbench/tests`` and by ``portbench/readings.py``
(the benchmark's own runs plant none): ``unchanged_state``, the step
returns the parameters and Adam's state unchanged; ``half_batch``, the step
trains on the first half of its batch, the mean taken over it;
``answer_altered``, the step's loss reported 5 % high. One chip, so no
exchange between chips can be left out.
"""

from __future__ import annotations

from typing import Dict, Tuple
from unittest import mock

import numpy as np
import torch

from satae_torch import config as C
from satae_torch.models.stacked import StackedSupervisedAE
from satae_torch.nn.layers import float32_convs
from satae_torch.train import hbm, steps
from satae_torch.train.optim import adam_init

from portbench import inputs
from portbench import work as W
from portbench.reference import model as R

FIRST_STEPS = 3
# a leaf counts in step_gap when its reference gradient norm is at least
# this share of the median leaf's
MOVED = 1e-3


def _leaf_norms(t: Dict[str, torch.Tensor], names) -> np.ndarray:
    """(configs, leaves) float64 norms of tensors stacked on a leading
    config axis."""
    return torch.stack([t[k].double().flatten(1).norm(dim=1) for k in names],
                       1).cpu().numpy()


class Session:
    first_steps = FIRST_STEPS

    def __init__(self, cell):
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        m, d, grid = cfg["model"], cfg["data"], cfg["ae"]
        self.m, self.d = m, d
        self.size, self.ch, self.batch = (d["image_size"], d["channels"],
                                          d["batch_size"])
        self.dtype = {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}[cfg["compute_dtype"]]
        self.hp = [(float(a), float(lr)) for a in grid["alphas"]
                   for lr in grid["learning_rates"]]
        c = len(self.hp)
        self.n_train = tr["train_images"]
        self.images, self.labels = inputs.images(
            self.n_train, self.size, self.ch, m["num_classes"],
            inputs.generator(cell.seed, dev, 1), dev)
        shapes = R.ae_shapes(m, self.size, self.ch)
        self.names = R.trainable(shapes)
        sd = inputs.tensors(shapes, inputs.generator(cell.seed, dev, 2), dev,
                            configs=c)
        mc = C.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in m.items()})
        self.data_cfg = C.DataConfig(
            image_size=self.size, channels=self.ch,
            num_classes=m["num_classes"], batch_size=self.batch,
            crop_padding=d["crop_padding"], noise_std=d["noise_std"])
        net = StackedSupervisedAE(mc, c, self.ch, self.size)
        net.load_state_dict(sd)
        self.net = net.to(dev)
        self.p0 = {k: sd[k].cpu() for k in self.names}
        del sd
        self.opt = adam_init(list(self.net.parameters()))
        self.aug_seed = inputs.derived_seed(cell.seed, 3)
        self.gen = torch.Generator(device=dev).manual_seed(self.aug_seed)
        self.alphas = torch.tensor([a for a, _ in self.hp], device=dev)
        self.lrs = torch.tensor([lr for _, lr in self.hp], device=dev)
        self.rows = self._row_stream()
        self.unit_steps = tr["unit_steps"]

        # the first steps, through the window's own call
        self.first_rows = [next(self.rows) for _ in range(FIRST_STEPS)]
        self.losses = []
        for k, row in enumerate(self.first_rows):
            sums = self._epoch(row[None])
            self.losses.append(sums["loss"] / self.batch)
            if k == 0:
                g1 = {n: mu / (1.0 - R.BETA1) for (n, _), mu in
                      zip(self.net.named_parameters(), self.opt.mu)}
                self.g1_norms = _leaf_norms(g1, self.names)
                del g1
        p3 = dict(self.net.named_parameters())
        self.step_norms = _leaf_norms(
            {k: p3[k].detach().double() - self.p0[k].to(dev).double()
             for k in self.names}, self.names)
        self.losses = np.stack(self.losses, 1)  # (configs, steps)
        self._ref = None

    def _row_stream(self):
        epoch = 0
        while True:
            order = hbm.epoch_order(self.n_train, self.batch,
                                    self.cell.seed, epoch)
            yield from order
            epoch += 1

    def _epoch(self, order: np.ndarray) -> Dict[str, np.ndarray]:
        """The program's epoch function over ``order``'s rows; the host
        reads its sums back."""
        with float32_convs(deterministic=True):
            sums = hbm.stacked_ae_train_epoch(
                self.net, self.opt, self.images, self.labels, order,
                self.alphas, self.lrs, self.data_cfg, self.gen, self.dtype)
        return {k: v.cpu().double().numpy().reshape(-1)
                for k, v in sums.items()}

    # -- the window --------------------------------------------------------

    def unit(self) -> Dict[str, int]:
        order = np.stack([next(self.rows) for _ in range(self.unit_steps)])
        self._epoch(order)
        return {"steps": self.unit_steps,
                "images": self.unit_steps * self.batch * len(self.hp)}

    def work(self, peak) -> Dict[str, float]:
        """Per unit: the model's FLOPs of its steps and their least time."""
        c, s = len(self.hp), self.unit_steps
        ops = W.train_ops(self.m, self.size, self.ch,
                          self.cell.config["compute_dtype"], self.batch, c)
        return {"flops": s * c * self.batch * W.train_flops_per_image(
                    self.m, self.size, self.ch),
                "least_s": s * W.least_s(ops, peak)}

    def release(self) -> None:
        self.net = self.opt = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def outputs(self):
        return {"losses": self.losses, "grad": self.g1_norms,
                "step": self.step_norms}

    def _reference_steps(self, q):
        """The reference's three steps of every config: losses (configs,
        steps) and the per-leaf norms of the first gradient and of the
        change after three steps, (configs, leaves)."""
        dev = self.cell.device
        gen = torch.Generator(device=dev).manual_seed(self.aug_seed)
        c = len(self.hp)
        draws = [R.draw_stacked(c, self.batch, self.size, self.ch,
                                self.d["crop_padding"], gen, dev, self.dtype)
                 for _ in self.first_rows]
        rows = [torch.from_numpy(r).to(dev) for r in self.first_rows]
        losses, g1n, stepn = [], [], []
        for i, (alpha, lr) in enumerate(self.hp):
            p0 = {k: v[i].to(dev) for k, v in self.p0.items()}
            batches = [(self.images[r], self.labels[r],
                        tuple(t[i] for t in dr))
                       for r, dr in zip(rows, draws)]
            ls, g1, p3 = R.train_steps(p0, self.names, batches, alpha, lr,
                                       self.m, self.d, q)
            losses.append(ls)
            g1n.append(_leaf_norms({k: v[None] for k, v in g1.items()},
                                   self.names)[0])
            stepn.append(_leaf_norms(
                {k: (p3[k].double() - p0[k].double())[None]
                 for k in self.names}, self.names)[0])
        return {"losses": np.array(losses), "grad": np.stack(g1n),
                "step": np.stack(stepn)}

    def control_outputs(self, q):
        return self._reference_steps(q)

    def compare(self, out, limits) -> Tuple[Dict[str, float], int]:
        """({"loss_gap", "grad_gap", "step_gap"}, steps judged wrong)."""
        if self._ref is None:
            self._ref = self._reference_steps(R.identity)
        ref = self._ref
        inf = lambda a: np.nan_to_num(a, nan=np.inf)
        # the first step's loss: the later steps' move apart by rounding at
        # the grid's largest rates, where Adam's first updates are +-lr on
        # every element (PERF.md §2)
        loss = inf(np.abs(out["losses"] - ref["losses"])
                   / np.abs(ref["losses"]))[:, 0]
        med = np.median(ref["grad"], axis=1, keepdims=True)
        moved = ref["grad"] >= MOVED * med
        grad = np.where(moved, np.abs(out["grad"] - ref["grad"])
                        / np.maximum(ref["grad"], med), 0.0)
        step_med = np.nanmedian(np.where(moved, ref["step"], np.nan),
                                axis=1, keepdims=True)
        step = np.where(moved, np.abs(out["step"] - ref["step"])
                        / np.maximum(ref["step"], step_med), 0.0)
        nums = {"loss_gap": float(loss.max()),
                "grad_gap": float(inf(grad).max()),
                "step_gap": float(inf(step).max())}
        # the raw readings behind the numbers, for a look at where each
        # comes from
        self.detail = {"hp": self.hp, "leaves": self.names,
                       "program": {k: np.asarray(v).tolist()
                                   for k, v in out.items()},
                       "reference": {k: np.asarray(v).tolist()
                                     for k, v in ref.items()}}
        # steps judged wrong: the first by its loss or gradient, all three
        # by the change they made
        wrong = 1 if (nums["loss_gap"] > limits["loss_gap"]
                      or nums["grad_gap"] > limits["grad_gap"]) else 0
        if nums["step_gap"] > limits["step_gap"]:
            wrong = FIRST_STEPS
        return nums, wrong


def setup(cell) -> Session:
    return Session(cell)


def _unchanged_state():
    return mock.patch.object(steps, "adam_update", lambda *a, **k: None)


def _wrap_step(wrap):
    return mock.patch.object(hbm, "stacked_ae_train_step",
                             wrap(hbm.stacked_ae_train_step))


def _half(step):
    def run(model, opt, imgs, labels, *a, **k):
        h = len(imgs) // 2
        return step(model, opt, imgs[:h], labels[:h], *a, **k)
    return run


def _loss_high(step):
    def run(*a, **k):
        metrics, grads = step(*a, **k)
        return dict(metrics, loss=metrics["loss"] * 1.05), grads
    return run


FAULTS = {"unchanged_state": _unchanged_state,
          "half_batch": lambda: _wrap_step(_half),
          "answer_altered": lambda: _wrap_step(_loss_high)}
