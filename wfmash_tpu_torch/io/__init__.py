from .fasta import FastaReader, FaiRecord
from .seqids import SequenceIdManager

__all__ = ["FastaReader", "FaiRecord", "SequenceIdManager"]
