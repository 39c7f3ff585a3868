"""The benchmark of the PyTorch/CUDA port (multimodal_segmentation_torch):
`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` on one H100. See BENCHMARK.json and PERF.md."""
