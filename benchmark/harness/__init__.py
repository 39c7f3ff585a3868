"""The harness of a cell, a module a kind (train, infer), found by name
by common.harness: its set-up, measured window and output check."""
