"""Feature and result visualization (the reference's analysis notebooks).

    python -m autovc_tpu_torch.cli.visualize --out_dir DIR path1 [path2 ...]

Counterpart of ``autovc_tpu/cli/visualize.py``: each ``.npy`` feature file
becomes a spectrogram PNG (a waveform a line plot); each ``.pkl`` manifest
has its structure printed (``describe_pickle``) and, for a results manifest
([(id, mel)]), each mel plotted. Plotting needs matplotlib, imported inside
``plot_features``; where it is missing (the card's machine has none),
plotting raises and says so, and ``describe_pickle`` still works. Nothing
here runs on a device.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def describe_pickle(path: str) -> None:
    """Print a metadata, train or results pickle's length and its first five
    rows, an array as its shape and dtype."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    print(f"{path}: {type(obj).__name__} of {len(obj)} entries")
    for i, row in enumerate(obj[:5]):
        if isinstance(row, (list, tuple)):
            parts = []
            for el in row:
                if isinstance(el, np.ndarray):
                    parts.append(f"ndarray{el.shape}:{el.dtype}")
                elif isinstance(el, (list, tuple)):
                    parts.append(f"{type(el).__name__}[{len(el)}]")
                else:
                    parts.append(repr(el)[:40])
            print(f"  [{i}] " + ", ".join(parts))
        else:
            print(f"  [{i}] {type(row).__name__}")


def plot_features(path: str, out_dir: str, arr: np.ndarray | None = None, tag: str | None = None) -> str:
    """``arr`` (or the ``.npy`` at ``path``) as ``<out_dir>/<name>.png``: a
    (T, bins) spectrogram as an image, anything else as a line."""
    try:
        import matplotlib
    except ImportError as exc:
        raise SystemExit("plotting needs matplotlib, which this Python does not have "
                         "(describe_pickle works without it)") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if arr is None:
        arr = np.load(path)
    name = tag or os.path.basename(path).rsplit(".", 1)[0]
    fig, ax = plt.subplots(figsize=(10, 4))
    if arr.ndim == 2 and arr.shape[1] > 1:  # spectrogram-like
        im = ax.imshow(arr.T * 100 - 100, origin="lower", aspect="auto")
        ax.set(title=f"{name} {arr.shape}", xlabel="frames", ylabel="bins")
        fig.colorbar(im, ax=ax)
    else:  # waveform
        ax.plot(arr.reshape(-1))
        ax.set(title=f"{name} {arr.shape}", xlabel="samples")
    out = os.path.join(out_dir, f"{name}.png")
    fig.savefig(out, dpi=90)
    plt.close(fig)
    print(f"[visualize] {out}")
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="+", help=".npy features or .pkl manifests")
    ap.add_argument("--out_dir", default=".")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for p in args.paths:
        if p.endswith(".npy"):
            plot_features(p, args.out_dir)
        elif p.endswith(".pkl"):
            describe_pickle(p)
            with open(p, "rb") as f:
                obj = pickle.load(f)
            for row in obj if isinstance(obj, list) else []:  # a results manifest's mels
                if isinstance(row, (list, tuple)) and len(row) == 2 and isinstance(row[1], np.ndarray):
                    plot_features(p, args.out_dir, arr=row[1], tag=f"result_{row[0]}")
        else:
            print(f"[visualize] skipping unknown file type: {p}")


if __name__ == "__main__":
    main()
