"""Physical constants (reference: src/ska-sdp-func/math/sdp_math_macros.h:23)."""

C_0 = 299792458.0
"""Speed of light in m/s."""
