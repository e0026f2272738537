"""Modular nominal metrics of the port (counterpart of ``tpumetrics/nominal``)."""

from tpumetrics_torch.nominal.cramers import CramersV
from tpumetrics_torch.nominal.fleiss_kappa import FleissKappa
from tpumetrics_torch.nominal.pearson import PearsonsContingencyCoefficient
from tpumetrics_torch.nominal.theils_u import TheilsU
from tpumetrics_torch.nominal.tschuprows import TschuprowsT

__all__ = [
    "CramersV",
    "FleissKappa",
    "PearsonsContingencyCoefficient",
    "TheilsU",
    "TschuprowsT",
]
