"""Pipeline orchestrator: pairs -> extract -> match (port of
``deep_image_matching_tpu/image_matching.py``).

Scans the image dir, loads the configured extractor and matcher by name,
generates pairs, extracts features into features.h5 and matches pairs into
raw_matches.h5 / matches.h5, with verification and gating inside the
matcher. This package carries the superpoint, aliked, sift, orb and
no_extractor extractors and the lightglue, kornia_matcher, superglue and roma
matchers; other presets and the upright stage are not ported yet
(ROADMAP.md, queue 1) and fail at construction.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Tuple

from . import extractors as extractors_pkg
from . import matchers as matchers_pkg
from .config import Config
from .extractors.extractor_base import extractor_loader
from .matchers.matcher_base import matcher_loader
from .pairs_generator import PairsGenerator
from .utils.image import ImageList
from .utils.timer import Timer

logger = logging.getLogger("dim_tpu_torch")

PORTED_EXTRACTORS = ("superpoint", "aliked", "sift", "orb", "no_extractor")
PORTED_MATCHERS = ("lightglue", "kornia_matcher", "superglue", "roma")


class ImageMatcher:
    def __init__(self, config: Config):
        self.config = config
        ext, mat = config.extractor["name"], config.matcher["name"]
        if ext not in PORTED_EXTRACTORS or mat not in PORTED_MATCHERS:
            raise NotImplementedError(
                f"Pipeline {ext}+{mat} is not ported to the PyTorch package "
                f"yet (ROADMAP.md, queue 1); ported extractors: "
                f"{', '.join(PORTED_EXTRACTORS)}; matchers: {', '.join(PORTED_MATCHERS)}"
            )
        if config.general.get("upright"):
            raise NotImplementedError(
                "--upright is not ported to the PyTorch package yet "
                "(ROADMAP.md, queue 1: retrieval and upright)"
            )
        self.image_dir = Path(config.image_dir)
        self.output_dir = Path(config.output_dir)
        self.image_list = ImageList(self.image_dir)
        logger.info(f"Found {len(self.image_list)} images in {self.image_dir}")

        cfg_dict = {
            "general": config.general,
            "extractor": config.extractor,
            "matcher": config.matcher,
        }
        # LightGlue picks its weight set by feature type
        if "features" not in config.matcher:
            cfg_dict["matcher"]["features"] = ext
        self.extractor = extractor_loader(extractors_pkg, ext)(cfg_dict)
        self.matcher = matcher_loader(matchers_pkg, mat)(cfg_dict)
        logger.info(f"Pipeline: extractor={ext} matcher={mat} on {self.matcher.device}")

    def run(self) -> Tuple[Path, Path]:
        """Full matching pipeline; returns (feature_path, match_path)."""
        timer = Timer(logger=logger, cumulate_by_key=True)
        pairs = self.generate_pairs()
        timer.update("generate_pairs")
        feature_path = self.extract_features()
        timer.update("extract_features")
        match_path = self.match_pairs(pairs, feature_path)
        timer.update("match_pairs")
        timer.print("ImageMatcher")
        return feature_path, match_path

    def generate_pairs(self) -> List[Tuple[str, str]]:
        general = self.config.general
        gen = PairsGenerator(
            self.image_list,
            general.get("matching_strategy", "bruteforce"),
            self.output_dir,
            overlap=general.get("overlap"),
            pair_file=general.get("pair_file"),
            retrieval=general.get("retrieval"),
            db_path=general.get("db_path"),
            config=self.config,
        )
        self.pairs = gen.run()
        return self.pairs

    def extract_features(self) -> Path:
        """Extract features; with general['resume'] an existing features.h5
        that covers every image is reused."""
        feature_path = self.output_dir / "features.h5"
        self.extractor.feature_cache = {}
        if feature_path.exists():
            if self.config.general.get("resume"):
                from .io.h5 import list_h5_names

                have = set(list_h5_names(feature_path))
                missing = [im for im in self.image_list if im.name not in have]
                if not missing:
                    logger.info(f"Resume: reusing features for all {len(self.image_list)} images")
                    return feature_path
                logger.info(f"Resume: extracting {len(missing)} missing images")
                self.extractor.extract_batch(missing, feature_path)
                return feature_path
            feature_path.unlink()
        self.extractor.extract_batch(list(self.image_list), feature_path)
        logger.info(f"Features saved to {feature_path}")
        return feature_path

    def match_pairs(self, pairs, feature_path: Path) -> Path:
        match_path = self.output_dir / "matches.h5"
        raw_path = self.output_dir / "raw_matches.h5"
        if self.config.general.get("resume") and raw_path.exists():
            from .io.h5 import list_pairs

            done = set(list_pairs(raw_path))
            todo = [p for p in pairs if tuple(p) not in done]
            logger.info(f"Resume: {len(pairs) - len(todo)} pairs already matched, "
                        f"{len(todo)} to go")
            pairs = todo
        else:
            for p in (match_path, raw_path):
                if p.exists():
                    p.unlink()
        self.matcher.feature_cache = self.extractor.feature_cache
        results = self.matcher.match_all(pairs, feature_path, match_path)
        kept = sum(1 for v in results.values() if v > 0)
        logger.info(f"Matched {kept}/{len(pairs)} pairs passed verification -> {match_path}")
        return match_path
