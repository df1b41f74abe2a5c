"""Multi-model comparison plots from saved vis_dict files.

    python3 -m emloco_tpu_torch.visualize_pred --vis-dicts A.pkl B.pkl ...
        [--games 4] [--out output/visualize_pred]

The counterpart of the JAX package's `visualize-pred` (cli/run.py:515-553;
reference visualize_pred.py and draw_histogram.py). Each file (written by
`eval_predictor --plots` or `save_vis_dict`, by either package) is named by
its base name, or by its directory and base name when two base names
collide (two identical names raise). It writes the comparison grid of the
first `--games` scenes, one value histogram per model that carries values,
and, with two models or more, the ADE/FDE improvement histograms of the
last file ("ours") against each other; it prints each path as one JSON
line. Host-only (numpy and matplotlib; without matplotlib it raises).
"""
from __future__ import annotations

import argparse
import json
import os

from .prediction import visualize as V


def load(paths) -> dict:
    """{key: vis_dict}, keyed as the module docstring says."""
    vis = {}
    for p in paths:
        k = os.path.splitext(os.path.basename(p))[0]
        if k in vis:
            k = f"{os.path.basename(os.path.dirname(p)) or '.'}/{k}"
        if k in vis:
            raise ValueError(f"duplicate vis_dict key {k!r}: pass files "
                             "from distinct directories or rename them")
        vis[k] = V.load_vis_dict(p)
    return vis


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vis-dicts", nargs="+", required=True)
    ap.add_argument("--games", type=int, default=4,
                    help="scenes in the comparison grid")
    ap.add_argument("--out", default="output/visualize_pred")
    args = ap.parse_args(argv)
    return run(args.vis_dicts, args.games, args.out)


def run(vis_dicts, games: int, out: str) -> dict:
    """`cmd_visualize_pred` (cli/run.py:515-553): the plots of the files
    `vis_dicts` in `out`; prints and returns their paths."""
    vis = load(vis_dicts)
    os.makedirs(out, exist_ok=True)
    n = min(v["pred"].shape[0] for v in vis.values())
    paths = {"comparison": V.plot_prediction_comparison(
        vis, list(range(min(games, n))),
        os.path.join(out, "pred_comparison.png"), value_threshold=0.7)}
    for name, v in vis.items():
        if "values" in v:
            paths[f"values_{name}"] = V.plot_value_histogram(
                {name: v["values"]},
                os.path.join(out, f"values_{name.replace('/', '_')}"
                             ".png"))
    if len(vis) > 1:
        ours = list(vis)[-1]
        paths["ours"] = ours
        paths["metric_diff"] = V.plot_metric_diff_histograms(
            vis, ours, os.path.join(out, "metric_diff_hist.png"))
    print(json.dumps(paths), flush=True)
    return paths


if __name__ == "__main__":
    main()
