// Definitions shared by the port's kernel sources (shannon_tpu_torch/csrc).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_KEY 0x7FFFFFFFFFFFFFFFLL
#define THREADS 256

static inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}
