// The FM discriminator's device functions, shared by first_order_scan.cu
// (fm_deemph_cols: the channelized FM bank's discriminator and
// de-emphasis) and bank_rotate.cu (the receiver bank's rotation and
// discriminator), so that the two discriminators cannot drift apart. Their
// plain versions are kernels/fastmath.patan2 and the conjugate product of
// kernels/iir.fm_deemph_cols and kernels/bank_rotate.fm_base; the sources
// that include this file are built with -fmad=false.

#pragma once

#include <cuda_runtime.h>

namespace fm_discriminator {

// kernels/fastmath.patan2, operation for operation: the six coefficients
// (Python floats rounded to f32) in Horner order from the last, the IEEE
// divide lo / hi, the octant fixes; 0 at (0, 0) and wherever x or y is NaN
// (torch.maximum keeps a NaN, and the plain version's hi > 0 then fails).
constexpr float ATAN0 = static_cast<float>(0.99997726);
constexpr float ATAN1 = static_cast<float>(-0.33262347);
constexpr float ATAN2 = static_cast<float>(0.19354346);
constexpr float ATAN3 = static_cast<float>(-0.11643287);
constexpr float ATAN4 = static_cast<float>(0.05265332);
constexpr float ATAN5 = static_cast<float>(-0.01172120);
constexpr float HALF_PI = static_cast<float>(1.5707963267948966);
constexpr float PI = static_cast<float>(3.141592653589793);

__device__ __forceinline__ float patan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  if (!(hi > 0.0f) || ax != ax || ay != ay) return 0.0f;
  const float t = fminf(ax, ay) / hi;
  const float z2 = t * t;
  float acc = ATAN5;
  acc = acc * z2 + ATAN4;
  acc = acc * z2 + ATAN3;
  acc = acc * z2 + ATAN2;
  acc = acc * z2 + ATAN1;
  acc = acc * z2 + ATAN0;
  float a = t * acc;
  if (ay > ax) a = HALF_PI - a;
  if (x < 0.0f) a = PI - a;
  if (y < 0.0f) a = -a;
  return a;
}

// The FM discriminator of frame v after frame p: arg(v conj(p)) / (2 pi
// kd) as kernels/iir.fm_deemph_cols computes it: the conjugate product as
// four real products, patan2, then the IEEE divide by f32(2 pi kd)
__device__ __forceinline__ float discriminator(float2 v, float2 p, float div) {
  const float dr = v.x * p.x + v.y * p.y;
  const float di = v.y * p.x - v.x * p.y;
  return patan2(di, dr) / div;
}

}  // namespace fm_discriminator
