"""Small versions of the cells that a CPU test run can hold."""

SMALL_CONFIG = {
    "stem_lite.train": {"corpus": {"generator": "family", "per_class": 3,
                                   "core_lengths": [30, 34], "model_core_length": 32, "core_seed": 7,
                                   "mutation": 0.1}},
    "stem_lite.predict": {"corpus": {"generator": "family", "per_class": 3,
                                     "core_lengths": [30, 34], "model_core_length": 32, "core_seed": 7,
                                     "mutation": 0.1}},
    "full_stem.train": {"corpus": {"generator": "mixed", "per_class": 3,
                                   "length_range": [30, 44]}},
}
SMALL_TRAFFIC = {"stem_lite.predict": {"support_vectors_per_class": 2, "test_per_class": 3}}
SEED = 2**31 + 4321
