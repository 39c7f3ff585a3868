"""The harness of a cell, by kind (train, infer): its set-up, measured window and output check."""
