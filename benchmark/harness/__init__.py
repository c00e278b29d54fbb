"""The benchmark's harness: finding a cell's parts by name (spec), the
scene drawn from the seed (scene), the profiler trace and its reduction
(trace), the kernels' bounds (roofline), and the result line (report)."""
