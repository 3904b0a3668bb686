"""Data substrate (port): numpy copies of ``repro.data`` — the synthetic
case studies, the hash tokenizer and the batch iterator; the same seed
gives the same data."""

from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import (CASE_STUDIES, CascadeSample,
                                        CaseStudy, make_classification_task,
                                        sample_case_study)
from repro_torch.data.tokenizer import HashTokenizer, reduce_domain

__all__ = ["CASE_STUDIES", "CaseStudy", "CascadeSample", "sample_case_study",
           "make_classification_task", "HashTokenizer", "reduce_domain",
           "BatchIterator"]
