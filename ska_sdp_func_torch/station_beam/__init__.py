"""Station and element beams (reference src/ska_sdp_func/station_beam)."""

from .element import dipole, spherical_wave_harp
from .station import aperture_array

__all__ = ["aperture_array", "dipole", "spherical_wave_harp"]
