// The stand-in for the links of csrc/tile_chain.cuh (its part from "32-bit
// slots of a link" on): blocks run in ticket order, so a link a block
// waits for is already written, or never will be (a fault: trap).
constexpr int LINK = 8;

template <int N>
inline void publish(float* link, const float (&v)[N], int epoch) {
  for (int i = 0; i < N; ++i) link[i] = v[i];
  reinterpret_cast<int*>(link)[LINK - 1] = epoch;
}

template <int N>
inline void await(const float* link, float (&v)[N], int epoch) {
  if (reinterpret_cast<const int*>(link)[LINK - 1] != epoch) __trap();
  for (int i = 0; i < N; ++i) v[i] = link[i];
}

struct Chain {
  unsigned* counter;
  unsigned base;
  int epoch;
  float* links;

  int ticket(int* slot) const {
    if (threadIdx.x == 0) *slot = static_cast<int>(atomicAdd(counter, 1u) - base);
    __syncthreads();
    return *slot;
  }
};

inline Chain make_chain(int* scratch, int base, int epoch) {
  return Chain{reinterpret_cast<unsigned*>(scratch), static_cast<unsigned>(base), epoch,
               reinterpret_cast<float*>(scratch + 4)};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel, size_t) { return cudaSuccess; }

}  // namespace tile_chain
