"""Dataset preparation CLI (port of unet_tpu/cli/prepare_data.py; the same
flags and the same bytes).

python -m unet_tpu_torch.cli.prepare_data --data_dir DIR \\
    [--output_name data.bin] [--size 64]

Writes every image under DIR (jpg/jpeg/png/gif, searched recursively in
sorted order; centre-cropped to a square and resized bicubically to
--size where it is not that size already) into the magic-20240620 .bin
dataset the trainer streams from.  Needs Pillow.
"""

from __future__ import annotations

import argparse

from unet_tpu_torch.data.dataset import images_to_bin
from unet_tpu_torch.utils.args import add_dict_to_argparser


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, dict(
        data_dir="", output_name="data.bin", size=64))
    args = parser.parse_args(argv)
    if not args.data_dir:
        parser.error("--data_dir is required")
    n = images_to_bin(args.data_dir, args.output_name, size=args.size)
    print(f"wrote {n} images to {args.output_name}")


if __name__ == "__main__":
    main()
