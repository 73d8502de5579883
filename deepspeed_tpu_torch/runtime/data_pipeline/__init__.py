"""Data-efficiency pipeline (``deepspeed_tpu/runtime/data_pipeline/``)."""
from .curriculum_scheduler import CurriculumScheduler
from .data_analyzer import DataAnalyzer
from .data_sampler import DeepSpeedDataSampler
from .indexed_dataset import (MMapIndexedDataset, MMapIndexedDatasetBuilder,
                              best_fitting_dtype, dataset_exists)
from .random_ltd import (RandomLTDScheduler, gather_tokens, random_ltd_layer, sample_token_indices,
                         scatter_tokens)
