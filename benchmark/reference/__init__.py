"""Plain PyTorch reference of the benchmarked work. It holds values in
float32 and rounds them at the configuration's compute dtype where the
program does (precision.py). It imports nothing of the program under
test."""
