"""Typed config with the reference's key surface.

Counterpart of gaitlab/config.py: a plain attribute-dict in place of the
reference's yacs tree, with the same keys (OUTPUT_DIR, DATASET.SEQLEN,
MODEL.FEAT_CORR.*, ...), the same YAML-merge semantics (`update_cfg`) and
the same `parse_args` entry, so config_grnet.yaml files load unchanged.
"""

from __future__ import annotations

import argparse
import copy
import os.path as osp

SMPL_DATA_DIR = "data/smpl_data"
GRNET_DATA_DIR = "data/grnet_data"


class ConfigNode(dict):
    """dict with attribute access, deep clone, and recursive YAML merge."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self._merge(data)

    def _merge(self, data: dict) -> None:
        for k, v in data.items():
            if k not in self:
                raise KeyError(f"Non-existent config key: {k}")
            if isinstance(self[k], ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Config key {k} expects a mapping")
                self[k]._merge(v)
            else:
                self[k] = v


def _defaults() -> ConfigNode:
    cfg = ConfigNode()
    cfg.OUTPUT_DIR = "results"
    cfg.EXP_NAME = "default"
    cfg.DEVICE = "cuda"
    cfg.LOGDIR = ""
    cfg.NUM_WORKERS = 8
    cfg.SEED_VALUE = -1

    cfg.CUDNN = ConfigNode()  # kept for YAML compatibility; unused
    cfg.CUDNN.BENCHMARK = True
    cfg.CUDNN.DETERMINISTIC = False
    cfg.CUDNN.ENABLED = True

    cfg.DATASET = ConfigNode()
    cfg.DATASET.SEQLEN = 100

    cfg.MODEL = ConfigNode()
    cfg.MODEL.PRETRAINED_PARE = osp.join(GRNET_DATA_DIR,
                                         "pare_w_3dpw_checkpoint.ckpt")
    cfg.MODEL.BACKBONE_CKPT = osp.join(GRNET_DATA_DIR, "hrnet_w32.pth.tar")
    cfg.MODEL.USE_GFEAT = True
    cfg.MODEL.FEAT_CORR = ConfigNode()
    cfg.MODEL.FEAT_CORR.AVG_DIM = 3
    cfg.MODEL.FEAT_CORR.ESTIM_PHASE = True
    cfg.MODEL.FEAT_CORR.NUM_LAYERS = 1
    cfg.MODEL.FEAT_CORR.H_SIZE = 1024
    cfg.MODEL.FEAT_CORR.NUM_HEADS = 4
    cfg.MODEL.FEAT_CORR.USE_JWFF = False
    return cfg


def get_cfg_defaults() -> ConfigNode:
    return _defaults()


def update_cfg(cfg_file: str) -> ConfigNode:
    cfg = get_cfg_defaults()
    cfg.merge_from_file(cfg_file)
    return cfg.clone()


DEFAULT_CFG_FILE = "configs/config_grnet.yaml"


def parse_args(args=None):
    """(cfg, cfg_file) from an argparse namespace with `.cfg`, or argv.

    A missing cfg file is fatal when explicitly requested; the *default*
    path falls back to built-in defaults (also tries the repo's
    shipped configs/ when the CWD has none) so the CLI works from any
    directory."""
    if args is None:
        parser = argparse.ArgumentParser()
        parser.add_argument("--cfg", type=str, help="cfg file path")
        args = parser.parse_args()
        print(args, end="\n\n")
    cfg_file = args.cfg
    if cfg_file is None:
        return get_cfg_defaults(), None
    if not osp.isfile(cfg_file) and cfg_file == DEFAULT_CFG_FILE:
        shipped = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                           DEFAULT_CFG_FILE)
        if osp.isfile(shipped):
            cfg_file = shipped
        else:
            print(f"config '{args.cfg}' not found; using built-in defaults")
            return get_cfg_defaults(), None
    return update_cfg(cfg_file), cfg_file
