"""Data substrate (port): the synthetic case studies, a numpy copy of
``repro.data.synthetic`` — the same seed gives the same task."""

from repro_torch.data.synthetic import (CASE_STUDIES, CascadeSample,
                                        CaseStudy, make_classification_task,
                                        sample_case_study)

__all__ = ["CASE_STUDIES", "CaseStudy", "CascadeSample", "sample_case_study",
           "make_classification_task"]
