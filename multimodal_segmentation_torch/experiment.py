"""The experiment CLI (reference experiment.py).

Port of multimodal_segmentation_tpu/experiment.py:22-152, the same CLI:
  python -m multimodal_segmentation_torch.experiment --config dafnet_config_chaos
      --split 0 [--l_mix f] [--test] [--randomise] [--dataset synthetic]
      [--test_dataset synthetic] [--epochs n] [--compute_dtype float32]
      [--device cuda|cpu]

`--device` is the one new flag: the run is on the GPU unless it says
'cpu'. The same artifacts: an output folder named from the config, the
pairing flags, l_mix, the modalities and the split (experiment.py:46-63),
experiment_configuration.json with the git hash (experiment.py:69-78) and
logfile.log (experiment.py:21-29). Presets dafnet_config_chaos (with
`--automatedpairing` or `--randomise`), dafnet_spade_config_chaos,
mmsdnet_config_chaos and cardiac_3d_config (the volumetric executor,
models/volumetric.py: training.csv, models/cardiac3d.npz,
test_results_cardiac/results.csv) run.
"""

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys


def read_console_parameters(argv=None):
    """reference experiment.py:100-111, plus --device."""
    parser = argparse.ArgumentParser(description="")
    parser.add_argument("--config", default="", help="The experiment settings")
    parser.add_argument("--test", help="Evaluate the model on test data", action="store_true")
    parser.add_argument("--split", help="Data split to run", required=True)
    parser.add_argument("--l_mix", help="Fraction of labelled data")
    parser.add_argument("--automatedpairing", help="Use automated pairing", action="store_true")
    parser.add_argument("--randomise", help="Randomise pairs", action="store_true")
    parser.add_argument("--test_dataset", help="Override test dataset")
    parser.add_argument("--epochs", help="Override number of epochs")
    parser.add_argument("--dataset", help="Override training dataset")
    parser.add_argument(
        "--compute_dtype",
        help="Activation dtype: float32 (default) or bfloat16",
        choices=["float32", "bfloat16"],
    )
    parser.add_argument("--device", default="cuda",
                        help="Where to run: cuda (default) or cpu")
    return parser.parse_args(argv)


def build_config(args):
    """reference experiment.py:31-72 (config resolution + folder naming):
    <folder>[_randomise][_automatedpairing]_l<l_mix>_<modalities>_split<N>
    with '.' stripped and the modalities joined by '_', as the JAX package
    names it."""
    from multimodal_segmentation_torch.config import get_config

    conf = get_config(args.config)
    conf.split = int(args.split)
    folder = conf.folder
    if args.randomise or conf.randomise:
        conf.randomise = True
        folder += "_randomise"
    if args.automatedpairing or conf.automatedpairing:
        conf.automatedpairing = True
        folder += "_automatedpairing"
    l_mix = conf.l_mix
    if args.l_mix is not None:
        conf.l_mix = float(args.l_mix)
        l_mix = args.l_mix
    folder += "_l%g" % float(l_mix)
    folder += "_" + "_".join(conf.modality)
    folder += "_split%s" % conf.split
    folder = folder.replace(".", "")
    if args.test_dataset:
        conf.test_dataset = args.test_dataset
    if args.dataset:
        conf.dataset_name = args.dataset
    if args.epochs:
        conf.epochs = int(args.epochs)
    if args.compute_dtype:
        conf.compute_dtype = args.compute_dtype
    conf.folder = folder
    return conf


def init_logging(folder):
    """reference experiment.py:21-29: INFO and above to <folder>/logfile.log
    and to stderr. Returns the file handler; the caller removes and closes
    it when the run ends, so runs in one process log to their own folders."""
    os.makedirs(folder, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    handlers = [logging.FileHandler(os.path.join(folder, "logfile.log"))]
    if not any(type(h) is logging.StreamHandler for h in root.handlers):
        handlers.append(logging.StreamHandler(sys.stderr))
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)
    return handlers[0]


def save_config(conf):
    """experiment_configuration.json with the git hash (experiment.py:69-78),
    'unknown' outside a git checkout."""
    d = dataclasses.asdict(conf)
    try:
        d["githash"] = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        d["githash"] = "unknown"
    with open(os.path.join(conf.folder, "experiment_configuration.json"), "w") as f:
        json.dump(d, f, indent=2, default=str)


class Experiment:
    """reference experiment.py:80-98."""

    def run(self, argv=None, **overrides):
        """Run the CLI on `argv` (default sys.argv). `overrides` set
        configuration fields after the flags, for a caller that caps a run
        (e.g. steps_per_epoch=4)."""
        args = read_console_parameters(argv)
        conf = dataclasses.replace(build_config(args), **overrides)
        logfile = init_logging(conf.folder)
        try:
            return self._run(args, conf)
        finally:
            logging.getLogger().removeHandler(logfile)
            logfile.close()

    def _run(self, args, conf):
        save_config(conf)

        import torch

        from multimodal_segmentation_torch.models import build_model
        from multimodal_segmentation_torch.train.executor import make_executor

        if conf.debug_nans:
            # the debug configuration's NaN guard (SURVEY.md §5.2): anomaly
            # mode for the backward; build_model and the 3-D segmenter hook
            # every module's forward (utils/nan_checks.py)
            torch.autograd.set_detect_anomaly(True)
        if conf.model == "cardiac3d":
            # the volumetric family (models/volumetric.py)
            from multimodal_segmentation_torch.models.volumetric import Cardiac3DExecutor

            executor = Cardiac3DExecutor(conf, device=args.device)
            if not args.test:
                executor.train()
            executor.test()
            return executor
        model = build_model(conf, device=args.device)
        executor = make_executor(conf, model, device=args.device)
        if not args.test:
            executor.train()
        else:
            executor.final_state, _ = executor.create_state()
        executor.test()
        return executor


if __name__ == "__main__":
    Experiment().run()
