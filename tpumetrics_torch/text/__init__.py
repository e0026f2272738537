"""Text metrics of the port (counterpart of ``tpumetrics/text``), less
BERTScore and InfoLM, which wait for the port's own encoder modules."""

from tpumetrics_torch.text.bleu import BLEUScore
from tpumetrics_torch.text.cer import CharErrorRate
from tpumetrics_torch.text.chrf import CHRFScore
from tpumetrics_torch.text.edit import EditDistance
from tpumetrics_torch.text.eed import ExtendedEditDistance
from tpumetrics_torch.text.mer import MatchErrorRate
from tpumetrics_torch.text.perplexity import Perplexity
from tpumetrics_torch.text.rouge import ROUGEScore
from tpumetrics_torch.text.sacre_bleu import SacreBLEUScore
from tpumetrics_torch.text.squad import SQuAD
from tpumetrics_torch.text.ter import TranslationEditRate
from tpumetrics_torch.text.wer import WordErrorRate
from tpumetrics_torch.text.wil import WordInfoLost
from tpumetrics_torch.text.wip import WordInfoPreserved

__all__ = [
    "BLEUScore",
    "CHRFScore",
    "CharErrorRate",
    "EditDistance",
    "ExtendedEditDistance",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SQuAD",
    "SacreBLEUScore",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
