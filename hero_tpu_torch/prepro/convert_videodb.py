"""SlowFast + ResNet ``.npz`` features to the video-feature store (the
port's ``scripts/convert_videodb.py``; reference
``scripts/collect_video_feature_paths.py`` + ``convert_videodb.py``).

    python -m hero_tpu_torch.prepro.convert_videodb \\
        --slowfast_dir SF --resnet_dir RN --output DB [--clip_interval S]
    python -m hero_tpu_torch.prepro.convert_videodb \\
        --feat_info video_feat_info.pkl --output DB

Pairs ``<vid>.npz`` of the two directories (or takes the pairs of
``scripts/collect_video_feature_paths.py``'s ``video_feat_info.pkl``),
concatenates each frame's features to 4352-d float16 and writes the store
and ``id2nframe.json`` (:func:`build_dbs.build_video_db`)."""

from __future__ import annotations

import argparse
import glob
import os

from hero_tpu_torch.prepro.build_dbs import build_video_db
from hero_tpu_torch.utils.basic_utils import load_pickle


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--slowfast_dir")
    p.add_argument("--resnet_dir")
    p.add_argument("--feat_info",
                   help="video_feat_info.pkl from "
                        "scripts/collect_video_feature_paths.py; "
                        "overrides the directory scan")
    p.add_argument("--output", required=True)
    p.add_argument("--clip_interval", default=-1, type=float,
                   help=">0 splits videos into fixed-second clips "
                        "(HowTo100M rule)")
    p.add_argument("--frame_length", default=1.5, type=float)
    return p


def feature_pairs(p: argparse.ArgumentParser, args) -> dict:
    """{vid: {"slowfast": path, "resnet": path}} of the arguments."""
    vid2paths = {}
    if args.feat_info:
        # {vid: (frame_len, slowfast_path, resnet_path, folder)}; "" marks
        # a file that failed to load: skip those records
        for vid, (_, sf, rn, _folder) in load_pickle(args.feat_info).items():
            if sf and rn:
                vid2paths[vid] = {"slowfast": sf, "resnet": rn}
    elif not (args.slowfast_dir and args.resnet_dir):
        p.error("need --feat_info or both --slowfast_dir/--resnet_dir")
    else:
        for path in sorted(glob.glob(os.path.join(args.slowfast_dir,
                                                  "*.npz"))):
            vid = os.path.splitext(os.path.basename(path))[0]
            rn = os.path.join(args.resnet_dir, f"{vid}.npz")
            if os.path.exists(rn):
                vid2paths[vid] = {"slowfast": path, "resnet": rn}
    return vid2paths


def main(argv=None) -> None:
    p = build_argparser()
    args = p.parse_args(argv)
    vid2paths = feature_pairs(p, args)
    corrupted = build_video_db(args.output, vid2paths,
                               clip_interval=args.clip_interval,
                               frame_length=args.frame_length)
    print(f"converted {len(vid2paths) - len(corrupted)} videos "
          f"({len(corrupted)} corrupted)")


if __name__ == "__main__":
    main()
