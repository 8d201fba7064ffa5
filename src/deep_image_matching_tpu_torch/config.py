"""Configuration system: presets, general options, YAML overrides, JSON snapshot.

Capability parity with the JAX package's config layer
(``deep_image_matching_tpu/config.py``), itself modelled on the reference:
- named pipeline presets (same names + hyperparameter keys, ``config.py:92-296``)
- three-tier merge: CLI args -> general defaults -> preset -> user YAML
  (``config.py:391-480, 670-740``)
- option registry ``opt_zoo`` (``config.py:298-336``)
- resolved-config JSON snapshot (``config.py:758-787``)

Execution options live under ``general["tpu"]``, a section name kept from
the JAX package so its YAML files load unchanged: batch sizes for the
padded extract/match batches, keypoint capacity padding, the on-device
RANSAC toggle, the matcher's compute dtype, the device and the device mesh
of the batched matchers (``mesh_devices``, read by
``parallel/mesh.py::mesh_devices``). Everything else is interchangeable with
reference YAML files.
"""

from __future__ import annotations

import json
import logging
import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

from .constants import GeometricVerification, Quality, TileSelection

logger = logging.getLogger("dim_tpu_torch")

# ---------------------------------------------------------------------------
# Defaults
# ---------------------------------------------------------------------------

cli_options_defaults: Dict[str, Any] = {
    "gui": False,
    "dir": None,
    "images": None,
    "outs": None,
    "pipeline": None,
    "config_file": None,
    "quality": "high",
    "tiling": "none",
    "strategy": "matching_lowres",
    "pair_file": None,
    "overlap": None,
    "global_feature": None,
    "db_path": None,
    "upright": False,
    "skip_reconstruction": False,
    "force": False,
    "verbose": False,
    "graph": True,
    "openmvg": None,
    "camera_options": None,
}

conf_general: Dict[str, Any] = {
    "quality": Quality.HIGH,
    "tile_selection": TileSelection.PRESELECTION,
    "tile_size": (2400, 2000),
    "tile_overlap": 10,
    "tile_preselection_size": 2000,
    "min_matches_per_tile": 10,
    "geometric_verification_per_tile": False,
    "gv_threshold_in_tiles_matching": 4,
    "geom_verification": GeometricVerification.MAGSAC,
    "gv_threshold": 4,
    "gv_confidence": 0.99999,
    "min_inliers_per_pair": 15,
    "min_inlier_ratio_per_pair": 0.15,
    # matching_lowres probe (reference low_resolution.py: SP@max-1000px)
    "lowres_probe_size": 1000,
    "lowres_min_matches": 20,
    "lowres_max_keypoints": 1024,
    "try_match_full_images": False,
    "preselection_pipeline": "superpoint+lightglue",
    # SfM backend: "auto" = pycolmap when installed, else the native
    # mapper (``sfm/incremental.py``, bundle adjustment on
    # ``general.tpu.device``); or force "pycolmap" / "native"
    "sfm_backend": "auto",
    # native-mapper options (sfm.MapperOptions fields), e.g. {"ba_global_every": 0}
    "sfm_options": None,
    # learned models ABORT when no pretrained checkpoint is found (matching
    # the reference, whose torch.hub download failure is a hard error); set
    # true (or env DIM_TPU_ALLOW_RANDOM_WEIGHTS=1) to run with random init
    # for development
    "allow_random_weights": False,
    # --- device execution options (section name kept for YAML compatibility) ---
    "tpu": {
        # images per extract batch (per size bucket) and pairs per match batch
        "extract_batch_size": 8,
        "match_batch_size": 16,
        # keypoint capacity = max_keypoints padded up to a multiple of 128
        "kpt_pad_multiple": 128,
        # the batched matchers' device mesh (parallel/mesh.py::mesh_devices):
        # null = every visible CUDA device when `device` is auto or cuda, else
        # the one device `device` names; N = the first N CUDA devices (raises
        # when fewer are visible, or on the CPU). The JAX package never reads
        # this key.
        "mesh_devices": None,
        # geometric verification placement: "auto" (default) runs the
        # RANSAC-family methods (MAGSAC/RANSAC/JAX_RANSAC) as the batched
        # on-device RANSAC whenever the matcher runs on CUDA; host OpenCV
        # stays the fidelity mode (any USAC_*/PYDEGENSAC/LMEDS/RHO choice,
        # or device_ransac: false)
        "device_ransac": "auto",
        "ransac_iters": 2048,
        # host-GV thread pool width (0 = cpu_count); the C++ solvers
        # release the GIL, so pairs verify concurrently
        "gv_workers": 0,
        # numerics for the matching transformer
        "dtype": "bfloat16",
        # "auto" (like "cuda") = the first CUDA device, failing at start
        # without one; "cpu" asks for the CPU (utils/device.py)
        "device": "auto",
    },
}

# Named pipeline presets. Names and hyperparameter keys match the reference
# (``config.py:92-296``) so users can carry over YAML files unchanged.
confs: Dict[str, Dict[str, Any]] = {
    "superpoint+lightglue": {
        "extractor": {
            "name": "superpoint",
            "nms_radius": 3,
            "keypoint_threshold": 0.0005,
            "max_keypoints": 2048,
        },
        "matcher": {
            "name": "lightglue",
            "n_layers": 9,
            "mp": False,
            "flash": True,
            "depth_confidence": 0.95,
            "width_confidence": 0.99,
            "filter_threshold": 0.1,
        },
    },
    "superpoint+lightglue_fast": {
        "extractor": {
            "name": "superpoint",
            "nms_radius": 3,
            "keypoint_threshold": 0.001,
            "max_keypoints": 1024,
        },
        "matcher": {
            "name": "lightglue",
            "n_layers": 7,
            "mp": False,
            "flash": True,
            "depth_confidence": 0.95,
            "width_confidence": 0.99,
            "filter_threshold": 0.1,
        },
    },
    "superpoint+superglue": {
        "extractor": {
            "name": "superpoint",
            "nms_radius": 3,
            "keypoint_threshold": 0.0005,
            "max_keypoints": 4096,
        },
        "matcher": {
            "name": "superglue",
            "weights": "outdoor",
            "match_threshold": 0.3,
            "sinkhorn_iterations": 100,
        },
    },
    "superpoint+kornia_matcher": {
        "extractor": {
            "name": "superpoint",
            "nms_radius": 3,
            "keypoint_threshold": 0.0005,
            "max_keypoints": 4096,
        },
        "matcher": {"name": "kornia_matcher", "match_mode": "smnn", "th": 0.95},
    },
    "superpoint_open+kornia_matcher": {
        "extractor": {
            "name": "superpoint_open",
            "nms_radius": 5,
            "keypoint_threshold": 0.005,
            "max_keypoints": 4096,
        },
        "matcher": {"name": "kornia_matcher", "match_mode": "smnn", "th": 0.95},
    },
    "liftfeat+kornia_matcher": {
        "extractor": {
            "name": "liftfeat",
            "max_keypoints": 4096,
            "detect_threshold": 0.05,
        },
        "matcher": {"name": "kornia_matcher", "match_mode": "smnn", "th": 0.99},
    },
    "ripe+kornia_matcher": {
        "extractor": {
            "name": "ripe",
            "max_keypoints": 4096,
            "detect_threshold": 0.5,
        },
        "matcher": {"name": "kornia_matcher", "match_mode": "smnn", "th": 0.95},
    },
    "disk+lightglue": {
        "extractor": {
            "name": "disk",
            "max_keypoints": 4096,
            "nms_window_size": 5,
            "detection_threshold": 0.0,
            "pad_if_not_divisible": True,
        },
        "matcher": {"name": "lightglue"},
    },
    "xfeat+lighterglue": {
        "extractor": {"name": "xfeat", "max_num_keypoints": 4096},
        "matcher": {"name": "lighterglue"},
    },
    "aliked+lightglue": {
        "extractor": {
            "name": "aliked",
            "model_name": "aliked-n16rot",
            "max_num_keypoints": 4000,
            "detection_threshold": 0.2,
            "nms_radius": 3,
        },
        "matcher": {
            "name": "lightglue",
            "n_layers": 9,
            "depth_confidence": 0.95,
            "width_confidence": 0.99,
            "filter_threshold": 0.1,
        },
    },
    "rdd_sparse+lightglue": {
        "extractor": {"name": "rdd_sparse", "max_num_keypoints": 4000},
        "matcher": {
            "name": "lightglue",
            "n_layers": 9,
            "depth_confidence": 0.95,
            "width_confidence": 0.99,
            "filter_threshold": 0.1,
            "input_dim": 256,
        },
    },
    "orb+kornia_matcher": {
        "extractor": {"name": "orb"},
        "matcher": {"name": "kornia_matcher", "match_mode": "snn"},
    },
    "sift+kornia_matcher": {
        "extractor": {
            "name": "sift",
            "n_features": 2048,
            "nOctaveLayers": 3,
            "contrastThreshold": 0.0004,
            "edgeThreshold": 10,
            "sigma": 1.6,
        },
        "matcher": {"name": "kornia_matcher", "match_mode": "smnn", "th": 0.85},
    },
    "loftr": {
        "extractor": {"name": "no_extractor"},
        "matcher": {"name": "loftr", "pretrained": "outdoor"},
    },
    "se2loftr": {
        "extractor": {"name": "no_extractor"},
        "matcher": {"name": "se2loftr", "pretrained": "outdoor"},
    },
    "roma": {
        "extractor": {"name": "no_extractor"},
        "matcher": {"name": "roma", "pretrained": "outdoor"},
    },
    "srif": {
        "extractor": {"name": "no_extractor"},
        "matcher": {"name": "srif", "pretrained": "outdoor"},
    },
    "keynetaffnethardnet+kornia_matcher": {
        "extractor": {"name": "keynetaffnethardnet", "n_features": 4000, "upright": False},
        "matcher": {"name": "kornia_matcher", "match_mode": "smnn", "th": 0.95},
    },
    "dedode+kornia_matcher": {
        "extractor": {"name": "dedode", "n_features": 4000, "upright": False},
        "matcher": {"name": "kornia_matcher", "match_mode": "smnn", "th": 0.99},
    },
}

opt_zoo: Dict[str, Any] = {
    "extractors": [
        "superpoint",
        "superpoint_open",
        "alike",
        "aliked",
        "disk",
        "dedode",
        "keynetaffnethardnet",
        "orb",
        "sift",
        "no_extractor",
        "rdd_sparse",
        "liftfeat",
        "ripe",
        "xfeat",
    ],
    "matchers": [
        "superglue",
        "lightglue",
        "loftr",
        "se2loftr",
        "srif",
        "adalam",
        "kornia_matcher",
        "roma",
        "lighterglue",
    ],
    # reference zoo (image_retrieval.py) + the explicit weight-free "tiny"
    # descriptor (this build is offline; see image_retrieval.py weight policy)
    "retrieval": ["netvlad", "openibl", "cosplace", "dir", "tiny"],
    "matching_strategy": [
        "bruteforce",
        "sequential",
        "retrieval",
        "custom_pairs",
        "matching_lowres",
        "covisibility",
    ],
    "upright_strategy": ["custom", "2clusters", "exif"],
}

_QUALITY_BY_NAME = {q.name.lower(): q for q in Quality}
_TILING_BY_NAME = {t.name.lower(): t for t in TileSelection}
_GV_BY_NAME = {g.name.lower(): g for g in GeometricVerification}


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


@dataclass
class Config:
    """Resolved pipeline configuration.

    Build order (reference ``config.py:391-480``): CLI defaults -> general
    defaults -> named preset -> optional YAML override -> validation ->
    ``config.json`` snapshot in the output dir.
    """

    args: Dict[str, Any] = field(default_factory=dict)
    general: Dict[str, Any] = field(default_factory=dict)
    extractor: Dict[str, Any] = field(default_factory=dict)
    matcher: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        merged_args = {**cli_options_defaults, **(self.args or {})}
        self.args = merged_args
        pipeline = merged_args.get("pipeline")
        if pipeline is None:
            raise ValueError(
                f"A pipeline must be given. Options: {list(confs.keys())}"
            )
        if pipeline not in confs:
            raise ValueError(
                f"Unknown pipeline '{pipeline}'. Options: {list(confs.keys())}"
            )
        preset = json.loads(json.dumps(confs[pipeline]))  # deep copy (plain data)
        self.general = {**_copy_general(), **(self.general or {})}
        self.extractor = {**preset["extractor"], **(self.extractor or {})}
        self.matcher = {**preset["matcher"], **(self.matcher or {})}

        self._parse_cli_args()
        if merged_args.get("config_file"):
            self.update_from_yaml(merged_args["config_file"])
        self._validate()
        self._setup_paths()
        if self.general.get("allow_random_weights"):
            from .utils.weights import set_allow_random_weights

            set_allow_random_weights(True)

    # -- CLI -> general mapping ---------------------------------------------
    def _parse_cli_args(self) -> None:
        a = self.args
        if a.get("quality"):
            q = a["quality"].lower() if isinstance(a["quality"], str) else a["quality"]
            self.general["quality"] = _QUALITY_BY_NAME[q] if isinstance(q, str) else q
        if a.get("tiling"):
            t = a["tiling"].lower() if isinstance(a["tiling"], str) else a["tiling"]
            self.general["tile_selection"] = (
                _TILING_BY_NAME[t] if isinstance(t, str) else t
            )
        strategy = a.get("strategy", "matching_lowres")
        if strategy not in opt_zoo["matching_strategy"]:
            raise ValueError(
                f"Invalid strategy '{strategy}'. Options: {opt_zoo['matching_strategy']}"
            )
        self.general["matching_strategy"] = strategy
        if strategy == "sequential":
            overlap = a.get("overlap")
            if overlap is None:
                raise ValueError("'sequential' strategy requires --overlap")
            self.general["overlap"] = int(overlap)
        elif strategy == "custom_pairs":
            pair_file = a.get("pair_file")
            if pair_file is None:
                raise ValueError("'custom_pairs' strategy requires --pair_file")
            self.general["pair_file"] = Path(pair_file)
        elif strategy == "retrieval":
            gf = a.get("global_feature")
            if gf is None:
                raise ValueError("'retrieval' strategy requires --global_feature")
            if gf not in opt_zoo["retrieval"]:
                raise ValueError(
                    f"Invalid global feature '{gf}'. Options: {opt_zoo['retrieval']}"
                )
            self.general["retrieval"] = gf
        elif strategy == "covisibility":
            db = a.get("db_path")
            if db is None:
                raise ValueError("'covisibility' strategy requires --db_path")
            self.general["db_path"] = Path(db)
        self.general["upright"] = bool(a.get("upright", False))
        self.general["resume"] = bool(a.get("resume", False))
        self.general["verbose"] = bool(a.get("verbose", False))
        self.general["graph"] = a.get("graph", True)
        self.general["skip_reconstruction"] = bool(a.get("skip_reconstruction", False))
        self.general["openmvg_conf"] = a.get("openmvg")
        self.general["camera_options"] = a.get("camera_options")

    # -- YAML override -------------------------------------------------------
    def update_from_yaml(self, path) -> None:
        """Merge a user YAML file over {general, extractor, matcher}.

        Reference ``config.py:670-740``: unknown keys warn; enum-valued general
        keys accept lowercase names; an extractor/matcher 'name' mismatch with
        the preset raises.
        """
        path = Path(path)
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
        known = {"general", "extractor", "matcher"}
        for section in cfg:
            if section not in known:
                logger.warning(f"Ignoring unknown config section '{section}'")
        def _enum(table, name, key):
            try:
                return table[str(name).lower()]
            except KeyError:
                raise ValueError(
                    f"Unknown {key} '{name}' in {path}; "
                    f"valid: {sorted(table)}"
                ) from None

        general = cfg.get("general") or {}
        for k, v in general.items():
            if k == "quality":
                v = _enum(_QUALITY_BY_NAME, v, "quality")
            elif k == "tile_selection":
                v = _enum(_TILING_BY_NAME, v, "tile_selection")
            elif k == "geom_verification":
                v = _enum(_GV_BY_NAME, v, "geom_verification")
            elif k == "tile_size" and isinstance(v, str):
                v = tuple(int(x) for x in v.strip("()[] ").split(","))
            if k not in conf_general and k not in (
                "matching_strategy", "overlap", "pair_file", "retrieval", "db_path",
                "upright", "resume", "verbose", "graph", "skip_reconstruction",
                "openmvg_conf", "camera_options",
            ):
                logger.warning(f"Unknown general option '{k}' (kept anyway)")
            if k == "tpu" and isinstance(v, dict):
                _deep_update(self.general.setdefault("tpu", {}), v)
            else:
                self.general[k] = v
        for section, target in (("extractor", self.extractor), ("matcher", self.matcher)):
            override = cfg.get(section) or {}
            if "name" in override and override["name"] != target.get("name"):
                # reference behavior (config.py:713-740): warn on a name
                # mismatch but apply the update - the YAML effectively swaps
                # the component (reflection loads by name)
                logger.warning(
                    f"YAML {section} name '{override['name']}' differs from the "
                    f"pipeline {section} '{target.get('name')}'; switching to "
                    f"'{override['name']}' with the YAML options"
                )
                target.clear()
            target.update(override)

    # -- validation & paths ---------------------------------------------------
    def _validate(self) -> None:
        if self.extractor["name"] not in opt_zoo["extractors"]:
            raise ValueError(f"Invalid extractor '{self.extractor['name']}'")
        if self.matcher["name"] not in opt_zoo["matchers"]:
            raise ValueError(f"Invalid matcher '{self.matcher['name']}'")
        if not isinstance(self.general["quality"], Quality):
            raise TypeError("general['quality'] must be a Quality enum")
        if not isinstance(self.general["tile_selection"], TileSelection):
            raise TypeError("general['tile_selection'] must be a TileSelection enum")
        if not isinstance(self.general["geom_verification"], GeometricVerification):
            raise TypeError(
                "general['geom_verification'] must be a GeometricVerification enum"
            )
        n = self.general.get("tpu", {}).get("mesh_devices")
        if n is not None and (isinstance(n, bool) or not isinstance(n, int) or n < 1):
            raise ValueError(f"general.tpu.mesh_devices must be a positive integer or null, "
                             f"not {n!r}")

    def _setup_paths(self) -> None:
        a = self.args
        if a.get("images") is not None:
            image_dir = Path(a["images"])
        elif a.get("dir") is not None:
            image_dir = Path(a["dir"]) / "images"
        else:
            image_dir = None
        if a.get("outs") is not None:
            out_dir = Path(a["outs"])
        elif a.get("dir") is not None:
            quality = self.general["quality"].name.lower()
            out_dir = (
                Path(a["dir"])
                / f"results_{a['pipeline']}_{a.get('strategy','matching_lowres')}_quality_{quality}"
            )
        else:
            out_dir = None
        if image_dir is not None and not image_dir.exists():
            raise FileNotFoundError(f"Image dir not found: {image_dir}")
        if out_dir is not None:
            if out_dir.exists() and a.get("force"):
                shutil.rmtree(out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
        self.general["image_dir"] = image_dir
        self.general["output_dir"] = out_dir

    # -- convenience ----------------------------------------------------------
    @property
    def image_dir(self) -> Optional[Path]:
        return self.general["image_dir"]

    @property
    def output_dir(self) -> Optional[Path]:
        return self.general["output_dir"]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "args": _jsonable(self.args),
            "general": _jsonable(self.general),
            "extractor": _jsonable(self.extractor),
            "matcher": _jsonable(self.matcher),
        }

    def save(self, path=None) -> Path:
        """Snapshot the resolved config as JSON (reference ``config.py:758-787``)."""
        if path is None:
            if self.output_dir is None:
                raise ValueError("No output dir to save config into")
            path = self.output_dir / "config.json"
        path = Path(path)
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)
        return path


def _copy_general() -> Dict[str, Any]:
    out = dict(conf_general)
    out["tpu"] = dict(conf_general["tpu"])
    return out


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, (Quality, TileSelection, GeometricVerification)):
        return obj.name
    return obj
