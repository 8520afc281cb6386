"""The benchmark of semstereo_tpu_torch on the H100 (``README.md``)."""
