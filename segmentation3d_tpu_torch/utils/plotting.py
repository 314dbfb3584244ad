"""Loss and validation curves as PNGs next to their csv files (the port's
copy of ``segmentation3d_tpu/utils/plotting.py``); no-ops without
matplotlib."""
from __future__ import annotations

import os


def plot_loss_curve(loss_csv: str, out_png: str | None = None):
    """Render ``train_loss.csv`` (epoch,batch,loss) to a PNG next to it.
    Silently no-ops when matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    batches, losses = [], []
    with open(loss_csv) as f:
        next(f)
        for line in f:
            parts = line.strip().split(",")
            if len(parts) == 3:
                batches.append(int(parts[1]))
                losses.append(float(parts[2]))
    if not losses:
        return None
    out_png = out_png or os.path.join(os.path.dirname(loss_csv), "train_loss.png")
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.plot(batches, losses, lw=1.0)
    ax.set_xlabel("batch")
    ax.set_ylabel("train loss")
    ax.set_yscale("log")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return out_png


def plot_val_curve(val_csv: str, out_png: str | None = None):
    """Render ``val_dice.csv`` (epoch,val_dice[,dice_c1,...]) to a PNG next
    to it — mean + per-class validation Dice over epochs. Silently no-ops
    when matplotlib is unavailable or the csv is absent/empty."""
    if not os.path.isfile(val_csv):
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    with open(val_csv) as f:
        header = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f if line.strip()]
    rows = [r for r in rows if len(r) == len(header)]
    if not rows:
        return None
    epochs = [int(float(r[0])) for r in rows]
    out_png = out_png or os.path.join(os.path.dirname(val_csv), "val_dice.png")
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for c in range(1, len(header)):
        vals = [float(r[c]) for r in rows]
        style = dict(lw=1.5) if header[c] == "val_dice" else \
            dict(lw=1.0, alpha=0.6, ls="--")
        ax.plot(epochs, vals, label=header[c], **style)
    ax.set_xlabel("epoch")
    ax.set_ylabel("validation Dice")
    ax.set_ylim(0.0, 1.0)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return out_png
