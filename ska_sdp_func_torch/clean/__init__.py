"""CLEAN deconvolution: Hogbom and multi-scale (Cornwell)."""

from .hogbom import create_cbeam, hogbom_clean
from .ms_clean import ms_clean_cornwell

__all__ = ["create_cbeam", "hogbom_clean", "ms_clean_cornwell"]
