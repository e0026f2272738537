"""Text metrics of the port (counterpart of ``tpumetrics/text``); BERTScore
and InfoLM run the port's own encoders (``text._bert_encoder``) or any model
with the same surface."""

from tpumetrics_torch.text.bert import BERTScore
from tpumetrics_torch.text.bleu import BLEUScore
from tpumetrics_torch.text.cer import CharErrorRate
from tpumetrics_torch.text.chrf import CHRFScore
from tpumetrics_torch.text.edit import EditDistance
from tpumetrics_torch.text.eed import ExtendedEditDistance
from tpumetrics_torch.text.infolm import InfoLM
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
    "BERTScore",
    "BLEUScore",
    "CHRFScore",
    "CharErrorRate",
    "EditDistance",
    "ExtendedEditDistance",
    "InfoLM",
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
