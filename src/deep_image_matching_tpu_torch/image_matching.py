"""Pipeline orchestrator: pairs -> extract -> match (port of
``deep_image_matching_tpu/image_matching.py``).

Scans the image dir, loads the configured extractor and matcher by name,
generates pairs, extracts features into features.h5 and matches pairs into
raw_matches.h5 / matches.h5, with verification and gating inside the
matcher. With ``general.upright`` the images are rotated upright before
extraction and the keypoints in features.h5 rotated back after matching
(``upright.py``). Where the extractor kept its features on the device (the
device handoff, ``extractors/extractor_base.py``) and they cover every
image of the pairs, the matcher builds its store from them; otherwise the
deferred features.h5 writer is joined first and matching reads the file.
The writer is joined before ``match_pairs`` returns, whatever happens, so
features.h5 is complete after it. This package carries every extractor and
matcher of the JAX package's zoo: superpoint, superpoint_open, alike,
aliked, disk, xfeat, keynetaffnethardnet, dedode, liftfeat, ripe,
rdd_sparse, sift, orb and no_extractor; lightglue, lighterglue,
kornia_matcher, adalam, superglue, roma, loftr, se2loftr and srif.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import List, Tuple

from . import extractors as extractors_pkg
from . import matchers as matchers_pkg
from .config import Config
from .extractors.extractor_base import extractor_loader
from .matchers.matcher_base import matcher_loader
from .pairs_generator import PairsGenerator
from .utils.image import ImageList
from .utils.profiler import span

logger = logging.getLogger("dim_tpu_torch")

PORTED_EXTRACTORS = ("superpoint", "superpoint_open", "alike", "aliked", "disk", "xfeat",
                     "keynetaffnethardnet", "dedode", "liftfeat", "ripe", "rdd_sparse", "sift",
                     "orb", "no_extractor")
PORTED_MATCHERS = ("lightglue", "lighterglue", "kornia_matcher", "adalam", "superglue", "roma",
                   "loftr", "se2loftr", "srif")


class ImageMatcher:
    def __init__(self, config: Config):
        self.config = config
        ext, mat = config.extractor["name"], config.matcher["name"]
        if ext not in PORTED_EXTRACTORS or mat not in PORTED_MATCHERS:
            raise NotImplementedError(
                f"Pipeline {ext}+{mat}: no such extractor or matcher in the PyTorch "
                f"package; ported extractors: {', '.join(PORTED_EXTRACTORS)}; matchers: "
                f"{', '.join(PORTED_MATCHERS)}"
            )
        self.image_dir = Path(config.image_dir)
        self.output_dir = Path(config.output_dir)
        with span("setup.images"):
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
        with span("setup.extractor"):
            self.extractor = extractor_loader(extractors_pkg, ext)(cfg_dict)
        with span("setup.matcher"):
            self.matcher = matcher_loader(matchers_pkg, mat)(cfg_dict)
        logger.info(f"Pipeline: extractor={ext} matcher={mat} on {self.matcher.device}")

    def run(self) -> Tuple[Path, Path]:
        """Full matching pipeline; returns (feature_path, match_path). Each
        stage is a span of ``utils/profiler.py`` (``pairs``, ``extract``,
        ``match``; ``upright`` and ``rotate_back`` with ``general.upright``),
        and their walls are logged on one ``[Timer]`` line."""
        t0 = time.time()
        walls = {}
        with span("pairs") as s:
            pairs = self.generate_pairs()
        walls["generate_pairs"] = s.seconds
        upright = self.config.general.get("upright")
        if upright:
            from .upright import rotate_upright_images

            with span("upright") as s:
                self.rotated = rotate_upright_images(self.image_list, self.output_dir,
                                                     self.config)
            walls["upright"] = s.seconds
        with span("extract") as s:
            feature_path = self.extract_features()
        walls["extract_features"] = s.seconds
        with span("match") as s:
            match_path = self.match_pairs(pairs, feature_path)
        walls["match_pairs"] = s.seconds
        if upright:
            from .upright import rotate_back_features

            with span("rotate_back") as s:
                rotate_back_features(feature_path, self.rotated)
            walls["rotate_back"] = s.seconds
        parts = ", ".join(f"{k}={v:.3f}s" for k, v in walls.items())
        logger.info(f"[Timer] | [ImageMatcher] {parts} (total={time.time() - t0:.3f}s)")
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
        handoff = getattr(self.extractor, "device_handoff", None)
        if handoff is not None and not handoff.covers({n for p in pairs for n in p}):
            # a handoff of part of the images (a --resume that extracted the
            # missing ones): matching reads features.h5, so it must be whole
            with span("wait.writer_join"):
                self.extractor.flush()
            handoff = None
        self.matcher.device_handoff = handoff
        try:
            results = self.matcher.match_all(pairs, feature_path, match_path)
        finally:
            with span("wait.writer_join"):
                self.extractor.flush()
            # the handoff's device tensors are not needed after matching
            self.extractor.device_handoff = self.matcher.device_handoff = None
        kept = sum(1 for v in results.values() if v > 0)
        logger.info(f"Matched {kept}/{len(pairs)} pairs passed verification -> {match_path}")
        if self.config.general.get("verbose") and kept:
            self._dump_debug_viz(feature_path, match_path, results)
        return match_path

    def _dump_debug_viz(self, feature_path, match_path, results) -> None:
        """Debug artifact under ``debug/``: the best-matched pair side by
        side with its verified matches. A failure here is logged with its
        traceback, not raised: the plot is a diagnostic of a finished stage."""
        try:
            from .io.h5 import get_features, get_matches
            from .utils.image import read_image
            from .visualization import viz_matches_cv2

            (name0, name1), _ = max(results.items(), key=lambda kv: kv[1])
            m = get_matches(match_path, name0, name1)
            f0, f1 = get_features(feature_path, name0), get_features(feature_path, name1)
            img0 = read_image(self.image_dir / name0, grayscale=False)[:, :, ::-1]
            img1 = read_image(self.image_dir / name1, grayscale=False)[:, :, ::-1]
            out = self.output_dir / "debug"
            out.mkdir(exist_ok=True)
            viz_matches_cv2(img0, img1, f0["keypoints"][m[:, 0]], f1["keypoints"][m[:, 1]],
                            output_path=out / f"matches_{name0}_{name1}.jpg")
            logger.debug(f"Debug match visualization written to {out}")
        except Exception as e:
            logger.warning(f"Debug viz failed: {e}", exc_info=True)
