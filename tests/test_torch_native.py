"""The port's host runtime is its own copy of the JAX package's source.

``ska_sdp_func_torch.native`` compiles ``src/host_runtime.cpp`` beside
it; the copy must stay byte-identical to the JAX package's
``native/src/host_runtime.cpp`` so that both packages build the same
plans (the plan-digest tests in test_torch_plan.py hold the plans
themselves).
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ska_sdp_func_torch")


def test_host_runtime_copy_is_byte_identical():
    with open(os.path.join(REPO, "ska_sdp_func_tpu", "native", "src",
                           "host_runtime.cpp"), "rb") as f:
        reference = f.read()
    with open(os.path.join(PORT, "native", "src", "host_runtime.cpp"),
              "rb") as f:
        copy = f.read()
    assert copy == reference


def test_native_builds_from_the_port():
    from ska_sdp_func_torch import native

    src = os.path.realpath(native._SRC)
    assert src.startswith(os.path.realpath(PORT) + os.sep)
    assert os.path.isfile(src)
