"""serve layer of the port (mirrors repro.serve): the column store, the
plan-group compiler and the batch engine, on one device or over a
row-sharded mesh."""
