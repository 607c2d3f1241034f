"""YAML config runner of the port — ``python -m movae_tpu_torch.runner``.

The counterpart of the repo's ``runner.py``: load flat YAML configs (the
schema of ``configs/`` is the flag schema), turn each into
``movae_tpu_torch.main`` arguments with the same alias map (agg ->
aggregator, wd -> weight_decay, normalize -> normalize_inputs,
num_samples -> num_vis_samples, norm_eps/reg_eps -> agg_norm_eps/
agg_reg_eps), dict values as JSON and bools as presence flags, and launch
one subprocess per config; ``--f`` repeats, ``--file-list`` reads a list,
failures are collected and make the exit code nonzero. ``--gpu_id`` pins a
run to one card through ``CUDA_VISIBLE_DEVICES``.

Usage: python -m movae_tpu_torch.runner --f configs/<...>/config_1.yaml
       python -m movae_tpu_torch.runner --file-list configs/<...>.txt
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import yaml

PROJECT_ROOT = Path(__file__).resolve().parent.parent

ALIASES = {
    "agg": "aggregator",
    "wd": "weight_decay",
    "normalize": "normalize_inputs",
    "num_samples": "num_vis_samples",
    "norm_eps": "agg_norm_eps",
    "reg_eps": "agg_reg_eps",
}

EXCLUDE_KEYS = {"device", "num_workers"}


def load_yaml_config(config_path):
    config_path = Path(config_path)
    if not config_path.is_absolute():
        config_path = PROJECT_ROOT / config_path
    if not config_path.exists():
        raise FileNotFoundError(f"Configuration file not found: {config_path}")
    with open(config_path) as f:
        return yaml.safe_load(f)


def yaml_to_args(config):
    """Flat YAML dict -> ``movae_tpu_torch.main`` argv."""
    args = []
    for key, value in config.items():
        if key in EXCLUDE_KEYS:
            continue
        arg_name = f"--{ALIASES.get(key, key)}"
        if isinstance(value, bool):
            if value:
                args.append(arg_name)
        elif isinstance(value, dict):
            args.extend([arg_name, json.dumps(value)])
        elif isinstance(value, list):
            args.append(arg_name)
            args.extend(str(v) for v in value)
        elif value is None:
            continue
        else:
            args.extend([arg_name, str(value)])
    return args


def run_single_config(config_file, device_id=None, num_workers=None):
    try:
        config = load_yaml_config(config_file)
    except (OSError, yaml.YAMLError) as e:
        print(f"Error loading configuration file {config_file}: {e}",
              file=sys.stderr)
        return False
    cmd_args = yaml_to_args(config)
    env = dict(os.environ)
    # the package is importable from the checkout whatever the cwd
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(PROJECT_ROOT), env.get("PYTHONPATH")) if p)
    if device_id is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(device_id)
    if num_workers is not None:
        cmd_args.extend(["--num_workers", str(num_workers)])
    cmd = [sys.executable, "-m", "movae_tpu_torch.main"] + cmd_args
    print(f"\n{'=' * 80}", flush=True)
    print(f"Running: {' '.join(cmd)}", flush=True)
    print(f"{'=' * 80}\n", flush=True)
    try:
        subprocess.run(cmd, check=True, env=env)
        return True
    except subprocess.CalledProcessError as e:
        print(f"Error running movae_tpu_torch.main with {config_file}: {e}",
              file=sys.stderr)
        return False
    except KeyboardInterrupt:
        print(f"\nInterrupted by user while running {config_file}",
              file=sys.stderr)
        return False


def main():
    parser = argparse.ArgumentParser(
        description="Run movae_tpu_torch.main with YAML configuration "
                    "file(s)")
    parser.add_argument("--f", dest="config_files", type=str, action="append",
                        help="Path to YAML configuration file (repeatable)")
    parser.add_argument("--file-list", dest="file_list", type=str,
                        help="Text file of YAML paths, one per line")
    parser.add_argument("--gpu_id", "--gpu", "--device_id", dest="device_id",
                        type=int, default=None,
                        help="Pin this run to one card")
    parser.add_argument("--num_workers", "--workers", dest="num_workers",
                        type=int, default=None)
    args = parser.parse_args()

    config_files = list(args.config_files or [])
    if args.file_list:
        file_list_path = Path(args.file_list)
        if not file_list_path.is_absolute():
            file_list_path = PROJECT_ROOT / file_list_path
        if not file_list_path.exists():
            print(f"Error: File list not found: {file_list_path}",
                  file=sys.stderr)
            sys.exit(1)
        with open(file_list_path) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    config_files.append(line.replace("\\", "/"))

    if not config_files:
        parser.error("At least one configuration file must be provided via "
                     "--f or --file-list")

    print(f"Found {len(config_files)} configuration file(s) to run:\n")
    for i, cf in enumerate(config_files, 1):
        print(f"  {i}. {cf}")

    failed = []
    for i, cf in enumerate(config_files, 1):
        print(f"\n[{i}/{len(config_files)}] Processing: {cf}")
        if not run_single_config(cf, device_id=args.device_id,
                                 num_workers=args.num_workers):
            failed.append(cf)

    print(f"\n{'=' * 80}")
    print(f"Summary: {len(config_files) - len(failed)}/{len(config_files)} "
          "configuration(s) completed successfully")
    if failed:
        print("Failed files:")
        for f in failed:
            print(f"  - {f}")
        sys.exit(1)
    print("All configurations completed successfully!")
    sys.exit(0)


if __name__ == "__main__":
    main()
