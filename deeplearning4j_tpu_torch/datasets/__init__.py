"""DataSet iterators: synchronous, sampled, replayed, and the
asynchronous prefetcher that stages batches on the device."""

from .iterators import (ArrayDataSetIterator, AsyncDataSetIterator,
                        DataSetIterator, ListDataSetIterator,
                        MultipleEpochsIterator, SamplingDataSetIterator,
                        as_iterator)

__all__ = ["DataSetIterator", "ListDataSetIterator", "ArrayDataSetIterator",
           "AsyncDataSetIterator", "MultipleEpochsIterator",
           "SamplingDataSetIterator", "as_iterator"]
