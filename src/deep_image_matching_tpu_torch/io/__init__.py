from .h5 import (  # noqa: F401
    get_features,
    get_keypoints,
    get_matches,
    list_h5_names,
    names_to_pair,
    save_features,
    save_matches,
)
from .h5_to_db import export_to_colmap  # noqa: F401
