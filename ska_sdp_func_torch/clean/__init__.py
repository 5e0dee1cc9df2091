"""CLEAN deconvolution."""

from .hogbom import create_cbeam, hogbom_clean

__all__ = ["create_cbeam", "hogbom_clean"]
