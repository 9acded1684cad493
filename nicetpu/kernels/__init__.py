"""Device compute path: vectorized tokenizer, histogram, bit-pack and decode.

The reference's serial hot loops (SURVEY §3.4) are reformulated as pure
tensor programs: every mode decision depends only on raw input bytes
(SURVEY §3.1), so tokenization is embarrassingly parallel; runs come from
suffix scans; bit offsets from an exclusive scan; packing from a word-level
scatter-add of disjoint bit ranges.
"""
