"""Matplotlib figures matching the reference notebook's outputs: the port's
copy of satae/eval/plots.py, the same figures under the same names.

matplotlib is imported with this module, so callers import it only where a
figure is drawn: a machine without matplotlib runs everything else.

One function per reference figure (all saved, never shown — headless Agg):
  class_distribution  — bar chart of per-class counts (Report.md:51-57)
  sample_grid         — 3x3 random images with class titles (Report.md:114-126)
  ratio_histogram     — CE/MSE init-ratio histogram (Report.md:520-525)
  gridsearch_heatmap  — alpha x lr val-loss heatmap (Report.md:2429-2438)
  loss_curves         — train/val loss curves (Report.md:2461-2469)
  accuracy_curves     — MLP train/val accuracy curves (Report.md:2706-2722)
  confusion_display   — confusion-matrix heatmap (Report.md:3191-3195)
plus two figures the notebook narrates but never draws:
  reconstruction_grid — originals vs x_hat (Report.md:429-433)
  latent_scatter      — PCA of the frozen latent space (Report.md:3237-3259)
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def _save(fig, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def class_distribution(labels: np.ndarray, classes: Sequence[str],
                       path: str | Path) -> Path:
    counts = np.bincount(np.asarray(labels), minlength=len(classes))
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(range(len(classes)), counts)
    ax.set_xticks(range(len(classes)))
    ax.set_xticklabels(classes, rotation=45, ha="right")
    ax.set_ylabel("images")
    ax.set_title("Class distribution")
    return _save(fig, path)


def sample_grid(images: np.ndarray, labels: np.ndarray,
                classes: Sequence[str], path: str | Path,
                seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(images), size=9, replace=False)
    fig, axes = plt.subplots(3, 3, figsize=(7, 7))
    for ax, i in zip(axes.flat, idx):
        ax.imshow(images[i])
        ax.set_title(classes[int(labels[i])], fontsize=9)
        ax.axis("off")
    return _save(fig, path)


def reconstruction_grid(originals: np.ndarray, recons: np.ndarray,
                        path: str | Path, n: int = 8) -> Path:
    """Originals (top row) vs autoencoder reconstructions (bottom row).
    ``originals`` uint8 or [0,1] floats; ``recons`` [0,1] floats — the
    qualitative view of the reference model's ``x_hat`` output
    (Report.md:429-433)."""
    n = min(n, len(originals))
    orig = np.asarray(originals[:n])
    if orig.dtype != np.uint8:
        orig = np.clip(orig, 0.0, 1.0)
    rec = np.clip(np.asarray(recons[:n]), 0.0, 1.0)
    fig, axes = plt.subplots(2, n, figsize=(1.6 * n, 3.6))
    axes = np.atleast_2d(axes).reshape(2, n)
    for i in range(n):
        axes[0, i].imshow(orig[i])
        axes[1, i].imshow(rec[i])
        axes[0, i].axis("off")
        axes[1, i].axis("off")
    axes[0, 0].set_title("original", fontsize=9, loc="left")
    axes[1, 0].set_title("reconstruction", fontsize=9, loc="left")
    return _save(fig, path)


def ratio_histogram(ratios: np.ndarray, path: str | Path) -> Path:
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(np.asarray(ratios), bins=40)
    ax.set_xlabel("CE / MSE at init")
    ax.set_ylabel("count")
    ax.set_title(f"Loss-scale calibration (median {np.median(ratios):.1f})")
    return _save(fig, path)


def gridsearch_heatmap(results: Dict[str, Dict[str, float]],
                       path: str | Path) -> Path:
    """results: the GridResultStore dict {key: {alpha, lr, best_val_loss}}."""
    entries = list(results.values())
    alphas = sorted({e["alpha"] for e in entries})
    lrs = sorted({e["lr"] for e in entries})
    mat = np.full((len(alphas), len(lrs)), np.nan)
    for e in entries:
        mat[alphas.index(e["alpha"]), lrs.index(e["lr"])] = e["best_val_loss"]
    fig, ax = plt.subplots(figsize=(1.2 * len(lrs) + 2, 1.0 * len(alphas) + 2))
    im = ax.imshow(mat, cmap="viridis")
    ax.set_xticks(range(len(lrs)))
    ax.set_xticklabels([f"{lr:g}" for lr in lrs], rotation=45)
    ax.set_yticks(range(len(alphas)))
    ax.set_yticklabels([f"{a:g}" for a in alphas])
    ax.set_xlabel("learning rate")
    ax.set_ylabel("alpha")
    ax.set_title("Validation loss (alpha x lr grid)")
    finite = np.isfinite(mat)
    for i in range(len(alphas)):
        for j in range(len(lrs)):
            if finite[i, j]:
                ax.text(j, i, f"{mat[i, j]:.3f}", ha="center", va="center",
                        color="white", fontsize=7)
    fig.colorbar(im, ax=ax)
    return _save(fig, path)


def loss_curves(history: Dict[str, list], path: str | Path,
                title: str = "Training curves") -> Path:
    fig, ax = plt.subplots(figsize=(7, 4))
    for k in ("train_loss", "val_loss"):
        if history.get(k):
            ax.plot(history[k], label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend()
    return _save(fig, path)


def accuracy_curves(history: Dict[str, list], path: str | Path,
                    title: str = "Accuracy curves") -> Path:
    fig, ax = plt.subplots(figsize=(7, 4))
    for k in ("train_acc", "val_acc"):
        if history.get(k):
            ax.plot(history[k], label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("accuracy")
    ax.set_title(title)
    ax.legend()
    return _save(fig, path)


def lr_curves(history: Dict[str, list], path: str | Path,
              title: str = "Curves") -> Path:
    """Per-config loss + accuracy panel, the reference's per-LR figure
    (Report.md:2706-2722: one loss plot and one accuracy plot per grid LR)."""
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for k in ("train_loss", "val_loss"):
        if history.get(k):
            ax1.plot(history[k], label=k)
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss")
    ax1.legend()
    for k in ("train_acc", "val_acc"):
        if history.get(k):
            ax2.plot(history[k], label=k)
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("accuracy")
    ax2.legend()
    fig.suptitle(title)
    return _save(fig, path)


def latent_scatter(latents: np.ndarray, labels: np.ndarray,
                   classes: Sequence[str], path: str | Path,
                   max_points: int = 4000, seed: int = 0) -> Path:
    """2-D PCA scatter of the frozen-encoder latent space, colored by class.

    The qualitative view behind the reference's results narration
    (Report.md:3237-3259 analyses which classes collapse together in the
    latent space — e.g. Forest->SeaLake — but the notebook never plots the
    space itself). PCA via numpy SVD on the centered latents; axes annotated
    with explained variance so collapsed-class overlap is readable."""
    z = np.asarray(latents, np.float64)
    y = np.asarray(labels)
    if len(z) > max_points:
        idx = np.random.default_rng(seed).choice(len(z), size=max_points,
                                                 replace=False)
        z, y = z[idx], y[idx]
    z = z - z.mean(axis=0)
    # economy SVD: rows are samples, right-singular vectors are components
    _, s, vt = np.linalg.svd(z, full_matrices=False)
    proj = z @ vt[:2].T
    if proj.shape[1] < 2:  # N=1 or 1-d latents: SVD yields one component
        proj = np.pad(proj, ((0, 0), (0, 2 - proj.shape[1])))
    var = s**2 / max(len(z) - 1, 1)
    frac = np.pad(var[:2], (0, max(0, 2 - len(var))))
    frac = frac / var.sum() if var.sum() else np.zeros(2)
    fig, ax = plt.subplots(figsize=(8, 7))
    cmap = plt.get_cmap("tab10")
    for c in range(len(classes)):
        m = y == c
        if m.any():
            ax.scatter(proj[m, 0], proj[m, 1], s=6, alpha=0.6,
                       color=cmap(c % 10), label=classes[c])
    ax.set_xlabel(f"PC1 ({frac[0]:.1%} var)")
    ax.set_ylabel(f"PC2 ({frac[1]:.1%} var)")
    ax.set_title("Latent space (PCA)")
    ax.legend(markerscale=2, fontsize=8, loc="best")
    return _save(fig, path)


def confusion_display(cm: np.ndarray, classes: Sequence[str],
                      path: str | Path) -> Path:
    cm = np.asarray(cm)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(classes)))
    ax.set_xticklabels(classes, rotation=45, ha="right")
    ax.set_yticks(range(len(classes)))
    ax.set_yticklabels(classes)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    thresh = cm.max() / 2 if cm.max() else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(int(cm[i, j])), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black",
                    fontsize=8)
    fig.colorbar(im, ax=ax)
    ax.set_title("Confusion matrix")
    return _save(fig, path)
