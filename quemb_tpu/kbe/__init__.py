"""Periodic bootstrap embedding (kbe): device-batched replacement for the
reference ``quemb.kbe`` package (reference kbe/__init__.py:1-4 exports
BE and fragmentate)."""

from quemb_tpu.kbe.cell import Cell
from quemb_tpu.kbe.df import KGDF, make_etb_aux
from quemb_tpu.kbe.fragment import KFragPart, fragmentate
from quemb_tpu.kbe.pbe import BE
from quemb_tpu.kbe.scf import KRHF

__all__ = ["BE", "Cell", "KGDF", "KRHF", "KFragPart", "fragmentate",
           "make_etb_aux"]
