"""Build a real-image training set from photos bundled with installed
packages (port of scripts/make_demo_dataset.py; the same flags, draws,
crops and bytes).

    python -m unet_tpu_torch.scripts.make_demo_dataset --out demo64.bin \\
        [--n 4096] [--size 64] [--seed 0] [--keep_crops DIR]

The photographs that ship inside sklearn (`china.jpg`, `flower.jpg`) and
matplotlib (`grace_hopper.jpg`) are cut into N random scale-jittered square
crops, resized bicubically to `--size`, written as PNG files and packed
into the `.bin` dataset by the port's own `cli.prepare_data`.  Nothing is
downloaded.  It needs Pillow (and sklearn or matplotlib for the photos),
imported only when it runs.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from unet_tpu_torch.cli import prepare_data


def source_images():
    """(name, PIL.Image) for every bundled photo whose package is
    installed; raises SystemExit when there is none."""
    from PIL import Image

    out = []
    try:
        from sklearn.datasets import load_sample_images
    except ImportError:
        pass
    else:
        for name, arr in zip(["china", "flower"],
                             load_sample_images().images):
            out.append((name, Image.fromarray(np.asarray(arr, np.uint8))))
    try:
        import matplotlib
    except ImportError:
        pass
    else:
        p = os.path.join(matplotlib.get_data_path(), "sample_data",
                         "grace_hopper.jpg")
        if os.path.exists(p):
            out.append(("hopper", Image.open(p).convert("RGB")))
    if not out:
        raise SystemExit("make_demo_dataset: no bundled source photos "
                         "(neither sklearn nor matplotlib is installed)")
    return out


def write_crops(dest: str, n: int, size: int, seed: int,
                class_prefix: bool = False) -> int:
    """n random scale-jittered square crops, bicubic-resized to `size`, as
    PNG files in `dest`; returns n.

    class_prefix=True names crops `<source>_<i>.png`, so that `--data_dir
    crops --class_cond true` takes the source as the label (the prefix
    before '_'); the default `<i>_<source>.png` keeps the sorted file order
    interleaved across sources, which a `.bin` read without shuffling needs
    (prepare_data packs the files in sorted order)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    sources = [(name, img) for name, img in source_images()
               if min(img.size) >= size]
    if not sources:
        raise SystemExit(f"make_demo_dataset: no source photo has a "
                         f"short side >= {size}px")
    os.makedirs(dest, exist_ok=True)
    for i in range(n):
        name, img = sources[rng.integers(len(sources))]
        # scale jitter: a crop between `size` and the full short side
        side = int(rng.integers(size, min(img.size) + 1))
        x0 = int(rng.integers(0, img.width - side + 1))
        y0 = int(rng.integers(0, img.height - side + 1))
        crop = img.crop((x0, y0, x0 + side, y0 + side))
        if side != size:
            crop = crop.resize((size, size), Image.BICUBIC)
        stem = f"{name}_{i:06d}" if class_prefix else f"{i:06d}_{name}"
        crop.save(os.path.join(dest, stem + ".png"))
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keep_crops", default="")
    args = p.parse_args(argv)

    crop_dir = args.keep_crops or tempfile.mkdtemp(prefix="demo_crops_")
    n = write_crops(crop_dir, args.n, args.size, args.seed)
    print(f"{n} crops in {crop_dir}")
    prepare_data.main(["--data_dir", crop_dir, "--output_name", args.out,
                       "--size", str(args.size)])
    if not args.keep_crops:
        for f in os.listdir(crop_dir):
            os.remove(os.path.join(crop_dir, f))
        os.rmdir(crop_dir)


if __name__ == "__main__":
    main()
