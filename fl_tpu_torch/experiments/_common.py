"""What the experiment drivers share: the device flag, the record's
path and the line that names the device a record was measured on."""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import Any, Optional

import torch

from fl_tpu_torch.core.mesh import resolve_device

# the port's records, beside the reference's docs/*.json
RECORD_DIR = Path(__file__).resolve().parents[2] / "docs" / "torch"


def add_port_flags(parser: argparse.ArgumentParser,
                   record: Optional[str] = None) -> None:
    """``--device`` (the card unless "cpu") and, for a driver that writes
    a record, ``--out`` (``docs/torch/<record>`` by default)."""
    parser.add_argument("--device", default="cuda",
                        help="torch device the engines run on (default: "
                             "the card; 'cpu' to run on the host)")
    if record is not None:
        parser.add_argument("--out", default=str(RECORD_DIR / record))


def device_of(args) -> torch.device:
    """The parsed ``--device``; without a card and without "cpu" this
    raises, as the engines do."""
    return resolve_device("the experiment", args.device, None)


def platform(device) -> str:
    """The device a record was measured on: the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or (f"{torch.cuda.get_device_name(index)}, power limit not "
                   "read (nvidia-smi failed)")


def write_record(path, record: Any, **dump_kw) -> Path:
    """``record`` as JSON at ``path``, its directory made if missing."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, **dump_kw))
    return path
