"""Imaging pipeline: the major-cycle CLEAN solver."""

from .major_cycle import ImagingResult, major_cycle_imager, make_psf_plan

__all__ = ["ImagingResult", "major_cycle_imager", "make_psf_plan"]
