"""Recorded measurement matrix transcribed from the paper's tables/figures.

The artifact's raw JSON is not shipped offline, so the published numbers
(Tables 2-5, Appendix B/C, named in-text values) are transcribed here as the
recorded dataset. benchmarks/* regenerate each table from these records and
EXPERIMENTS.md validates our analysis pipeline reproduces the paper's
derived claims (gaps, tiers, counts) from its own numbers.
"""
from __future__ import annotations

from typing import Optional

PLATFORMS = ["Intel 8581C", "AMD Zen 4", "AMD Zen 5", "Neoverse V2",
             "Neoverse N1"]

DECODERS = ["simplejpeg", "turbojpeg", "jpeg4py", "kornia-rs", "ajpegli",
            "opencv", "imagecodecs", "pyvips", "pillow", "skimage",
            "imageio", "torchvision", "tensorflow"]

# Strict decoders: skip ImageNet-val index 19876 on every platform (§4.4)
STRICT_SKIP_DECODERS = ["ajpegli", "jpeg4py", "kornia-rs", "turbojpeg"]
ZERO_SKIP_DECODERS = ["opencv", "pillow", "skimage", "imageio",
                      "imagecodecs", "torchvision", "tensorflow", "pyvips",
                      "simplejpeg"]
RARE_SKIP_INDEX = 19876

# Not PyTorch-DataLoader decode paths in the paper's harness
NOT_LOADER_ELIGIBLE = ["pyvips", "tensorflow"]

# ---- Table 2: protocol disagreement ------------------------------------
TABLE2 = {
    "Intel 8581C": {"single_leader": "simplejpeg",
                    "loader_leader": "simplejpeg",
                    "rho": 0.69, "largest_move": ("imageio", 10, 6)},
    "AMD Zen 4":   {"single_leader": "simplejpeg",
                    "loader_leader": "torchvision",
                    "rho": 0.48, "largest_move": ("ajpegli", 11, 5)},
    "AMD Zen 5":   {"single_leader": "torchvision",
                    "loader_leader": "torchvision",
                    "rho": 0.44, "largest_move": ("ajpegli", 11, 2)},
    "Neoverse V2": {"single_leader": "simplejpeg",
                    "loader_leader": "imageio",
                    "rho": 0.01, "largest_move": ("imagecodecs", 2, 10)},
    "Neoverse N1": {"single_leader": "imagecodecs",
                    "loader_leader": "simplejpeg",
                    "rho": 0.26, "largest_move": ("ajpegli", 11, 4)},
}

# ---- Table 3: worker-count scaling (11 loader-supported decoders) -------
TABLE3 = {
    "Intel 8581C": {"peak_w4": 1, "peak_w8": 10, "mean_speedup": 2.75},
    "AMD Zen 4":   {"peak_w4": 8, "peak_w8": 3, "mean_speedup": 2.51},
    "AMD Zen 5":   {"peak_w4": 0, "peak_w8": 11, "mean_speedup": 3.64},
    "Neoverse V2": {"peak_w4": 0, "peak_w8": 11, "mean_speedup": 4.28},
    "Neoverse N1": {"peak_w4": 1, "peak_w8": 10, "mean_speedup": 3.73},
}
NUM_LOADER_DECODERS = 11

# ---- Table 4: robust zero-skip near-optimal tier (normalized peak) ------
TABLE4 = {
    "torchvision": {"mean": 0.977, "min": 0.919, "max": 1.000,
                    "platforms": "5/5"},
    "simplejpeg":  {"mean": 0.967, "min": 0.938, "max": 1.000,
                    "platforms": "5/5"},
    "opencv":      {"mean": 0.941, "min": 0.911, "max": 0.974,
                    "platforms": "5/5"},
}
PRACTICAL_FLOOR = 0.90

# ---- Table 5: per-platform zero-skip DataLoader starting points ---------
TABLE5 = {
    "Intel 8581C": [("simplejpeg", 1754, 8), ("opencv", 1707, 8),
                    ("imagecodecs", 1677, 8)],
    "AMD Zen 4":   [("torchvision", 1596, 8), ("imagecodecs", 1543, 4),
                    ("simplejpeg", 1521, 4)],
    "AMD Zen 5":   [("torchvision", 2920, 8), ("opencv", 2814, 8),
                    ("simplejpeg", 2739, 8)],
    "Neoverse V2": [("imageio", 2561, 8), ("torchvision", 2557, 8),
                    ("simplejpeg", 2421, 8)],
    "Neoverse N1": [("simplejpeg", 1557, 8), ("torchvision", 1504, 8),
                    ("imageio", 1466, 8)],
}

# ---- named in-text values ------------------------------------------------
NEOVERSE_V2_W8 = {"imageio": (2561, 50), "torchvision": (2557, 150)}
ZEN4_TORCHVISION_W8 = (1596, 71)
# "Choosing the single-thread leader ... leaves measured peak-loader
#  throughput X% below the DataLoader leader"
SINGLE_LEADER_GAPS = {"AMD Zen 4": 0.047, "Neoverse V2": 0.055,
                      "Neoverse N1": 0.074}
# TensorFlow single-thread throughput (Fig 3 + §4.4)
TENSORFLOW_SINGLE_THREAD = {"Intel 8581C": 689, "AMD Zen 5": 836,
                            "Neoverse V2": 391, "Neoverse N1": 268}
# §4.3 scaling anecdotes
LOADER_SPEEDUPS = {("imageio", "Neoverse V2"): 5.08,
                   ("imageio", "Neoverse N1"): 4.39,
                   ("skimage", "Neoverse V2"): 4.66}
ZEN5_AJPEGLI_W4_TO_W8 = 0.63      # +63% from w=4 to w=8
# Figure 1/Table 2 rank anecdotes (single-thread rank -> loader tier)
SINGLE_THREAD_RANKS = {("imageio", "Neoverse V2"): 9,
                       ("torchvision", "AMD Zen 4"): 7}

GCP_MACHINES = {
    "Intel 8581C": "c4-standard-16",
    "AMD Zen 4": "c3d-standard-16",
    "AMD Zen 5": "c4d-standard-16",
    "Neoverse V2": "c4a-standard-16",
    "Neoverse N1": "t2a-standard-16",
}

# Appendix C package versions (identical across platforms)
PACKAGE_VERSIONS = {
    "simplejpeg": "1.9.0", "turbojpeg": "1.8.3", "jpeg4py": "0.1.4",
    "kornia-rs": "0.1.10", "ajpegli": "1.0.0", "opencv": "4.13.0.92",
    "imagecodecs": "2026.3.6", "pyvips": "3.1.1", "pillow": "12.2.0",
    "skimage": "0.26.0", "imageio": "2.37.3", "torchvision": "0.26.0+cpu",
    "tensorflow": "2.21.0", "torch": "2.11.0+cpu",
}


def implied_peak(platform: str, decoder: str) -> Optional[float]:
    """Peak loader throughput implied by Table 5 (exact) or the named gap
    values (derived) — used by the consistency validation."""
    for name, v, _w in TABLE5.get(platform, []):
        if name == decoder:
            return float(v)
    return None
