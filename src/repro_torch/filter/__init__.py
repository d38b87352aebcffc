"""Filtered multi-vector search: attribute store, predicate AST,
selectivity estimation (DESIGN.md §12)."""
from repro_torch.filter.attributes import (NUMERIC, TAG, TEXTHASH, AttributeStore,
                                     FieldSpec, synth_attributes, text_hash)
from repro_torch.filter.predicate import (And, Eq, In, Not, Or, Predicate, Range,
                                    describe)
from repro_torch.filter.selectivity import (BITMAP_COST, GATHER_OVERHEAD,
                                      SelectivityEstimator, inflate_eks,
                                      masked_scan_cost, prefilter_cost)

__all__ = [
    "AttributeStore", "FieldSpec", "synth_attributes", "text_hash",
    "TAG", "NUMERIC", "TEXTHASH",
    "Predicate", "Eq", "In", "Range", "And", "Or", "Not", "describe",
    "SelectivityEstimator", "inflate_eks", "masked_scan_cost",
    "prefilter_cost", "GATHER_OVERHEAD", "BITMAP_COST",
]
