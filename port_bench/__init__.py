"""The benchmark of ska_sdp_func_torch on one H100: see README.md."""
