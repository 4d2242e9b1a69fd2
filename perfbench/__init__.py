"""The benchmark of rangeldm_tpu_torch (run.py); see README.md."""
