"""Synchronous DataSet iterators."""

from .iterators import (ArrayDataSetIterator, DataSetIterator,
                        ListDataSetIterator, as_iterator)

__all__ = ["DataSetIterator", "ListDataSetIterator", "ArrayDataSetIterator",
           "as_iterator"]
