"""Local asset lookup.

Counterpart of `resolve_asset` in gaitlab/pipeline/fetch.py. This build
downloads nothing: files such as YOLO weights are placed under
$GAITLAB_ASSET_DIR (default `data`) beforehand.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

ASSET_DIR = os.environ.get("GAITLAB_ASSET_DIR", "data")


def resolve_asset(name: str, asset_dir: Optional[str] = None) -> str:
    """Find `name` under the local asset directory (recursively)."""
    root = asset_dir or ASSET_DIR
    direct = osp.join(root, name)
    if osp.isfile(direct):
        return direct
    for dirpath, _, files in os.walk(root):
        if name in files:
            return osp.join(dirpath, name)
    raise FileNotFoundError(
        f"asset '{name}' not found under '{root}'. This build downloads "
        f"nothing; place the file there or set GAITLAB_ASSET_DIR.")
