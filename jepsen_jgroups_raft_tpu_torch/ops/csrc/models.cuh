// Device steps of the port's models, shared by the CUDA kernels
// (dense_scan.cu, mask_scan.cu, sort_scan.cu, segment_scan.cu). Each
// `step<MODEL>` is the device twin of a model's `torch_step`
// (models/register.py, counter.py, queuemodel.py, setmodel.py,
// listappend.py):
// (state, op f a b) -> (state', legal); `mask_delta<MODEL>` and
// `always_legal<MODEL>` are the twins of the mask-mode models'
// `mask_delta` and `always_legal`. Ids match the Python models'
// KERNEL_MODEL.
//
// Integers: the reference's int32 arithmetic wraps, and signed overflow
// is undefined in C++, so every sum that may overflow is taken in
// uint32_t and cast back. The queue reads its tail field with `>>` on a
// signed int32, an arithmetic shift on this compiler, as on the
// reference (it matters only for negative states, which arbitrary rows
// can reach).

#pragma once

#include <cstdint>

namespace {

constexpr int kModelCasRegister = 0;
constexpr int kModelCounter = 1;
constexpr int kModelQueue = 2;
constexpr int kModelSet = 3;
constexpr int kModelListAppend = 4;

// CAS register opcodes (models/register.py).
constexpr int32_t kRegWrite = 1;
constexpr int32_t kRegCas = 2;

// Counter opcodes (models/counter.py).
constexpr int32_t kCtrRead = 0;
constexpr int32_t kCtrAdd = 1;
constexpr int32_t kCtrAddAndGet = 2;

// Ticket-queue opcodes and fields (models/queuemodel.py).
constexpr int32_t kQueEnq = 0;
constexpr int32_t kQueEnqAny = 1;
constexpr int32_t kQueDeq = 2;
constexpr int32_t kQueDeqEmpty = 3;
constexpr int32_t kQueDeqAny = 4;
constexpr int kTicketBits = 15;
constexpr int32_t kTicketMax = (1 << kTicketBits) - 1;

// Grow-only set opcodes (models/setmodel.py); any other opcode acts as a
// read, as in `torch_step`.
constexpr int32_t kSetAdd = 0;

// List-append opcodes and packing (models/listappend.py): base-32 digits,
// the packed-prefix bound 32^5.
constexpr int32_t kLstRead = 0;
constexpr int32_t kLstAppend = 1;
constexpr int32_t kLstAppendAny = 2;
constexpr uint32_t kLstBase = 32u;
constexpr int32_t kLstPrefixMax = 32 * 32 * 32 * 32 * 32;

__device__ __forceinline__ int32_t wrap_add(int32_t x, uint32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + y);
}

template <int MODEL>
struct Model;

template <>
struct Model<kModelCasRegister> {
  __device__ __forceinline__ static void step(int32_t state, int32_t f,
                                              int32_t a, int32_t b,
                                              int32_t* next, bool* legal) {
    const bool is_write = f == kRegWrite;
    const bool match = state == a;
    *legal = is_write || match;  // read/cas legal iff observed matches
    *next = is_write ? a : ((f == kRegCas && match) ? b : state);
  }
};

template <>
struct Model<kModelCounter> {
  __device__ __forceinline__ static void step(int32_t state, int32_t f,
                                              int32_t a, int32_t b,
                                              int32_t* next, bool* legal) {
    const int32_t added = wrap_add(state, static_cast<uint32_t>(a));
    *legal = f == kCtrAdd || (f == kCtrRead && state == a) ||
             (f == kCtrAddAndGet && added == b);
    *next = f == kCtrRead ? state : added;
  }
  // exactly the term of `step`'s legality that reads no state
  __device__ __forceinline__ static bool always_legal(int32_t f) {
    return f == kCtrAdd;
  }
  __device__ __forceinline__ static uint32_t mask_delta(int32_t f, int32_t a,
                                                        int32_t) {
    return f == kCtrRead ? 0u : static_cast<uint32_t>(a);
  }
};

template <>
struct Model<kModelQueue> {
  __device__ __forceinline__ static void step(int32_t state, int32_t f,
                                              int32_t a, int32_t,
                                              int32_t* next, bool* legal) {
    const int32_t h = state & kTicketMax;
    const int32_t t = (state >> kTicketBits) & kTicketMax;
    const bool enq = f == kQueEnq || f == kQueEnqAny;
    const bool deq = f == kQueDeq || f == kQueDeqAny;
    const bool nonempty = h < t;
    *legal = f == kQueEnqAny || (f == kQueEnq && a == t) ||
             (f == kQueDeqAny && nonempty) ||
             (f == kQueDeq && nonempty && a == h) ||
             (f == kQueDeqEmpty && h == t);
    *next = wrap_add(state,
                     (deq ? 1u : 0u) + (enq ? 1u << kTicketBits : 0u));
  }
  // exactly the term of `step`'s legality that reads no state
  __device__ __forceinline__ static bool always_legal(int32_t f) {
    return f == kQueEnqAny;
  }
  __device__ __forceinline__ static uint32_t mask_delta(int32_t f, int32_t,
                                                        int32_t) {
    const bool enq = f == kQueEnq || f == kQueEnqAny;
    const bool deq = f == kQueDeq || f == kQueDeqAny;
    return enq ? 1u << kTicketBits : (deq ? 1u : 0u);
  }
};

template <>
struct Model<kModelSet> {
  __device__ __forceinline__ static void step(int32_t state, int32_t f,
                                              int32_t a, int32_t,
                                              int32_t* next, bool* legal) {
    const bool is_add = f == kSetAdd;
    *legal = is_add || state == a;  // a read pins the whole membership
    *next = is_add ? (state | a) : state;
  }
  // exactly the term of `step`'s legality that reads no state
  __device__ __forceinline__ static bool always_legal(int32_t f) {
    return f == kSetAdd;
  }
  // the add's element bit: equal to the OR only for the histories the
  // router proves additive (`GSet.mask_eligible`)
  __device__ __forceinline__ static uint32_t mask_delta(int32_t f, int32_t a,
                                                        int32_t) {
    return f == kSetAdd ? static_cast<uint32_t>(a) : 0u;
  }
};

template <>
struct Model<kModelListAppend> {
  __device__ __forceinline__ static void step(int32_t state, int32_t f,
                                              int32_t a, int32_t b,
                                              int32_t* next, bool* legal) {
    // the bound is a signed compare: a negative state may append
    *legal = ((f == kLstRead || f == kLstAppend) && state == a) ||
             (f == kLstAppendAny && state < kLstPrefixMax);
    // products and sums in uint32_t wrap as the reference's int32 does
    const uint32_t appended = static_cast<uint32_t>(a) * kLstBase +
                              static_cast<uint32_t>(b);
    const uint32_t shifted = static_cast<uint32_t>(state) * kLstBase +
                             static_cast<uint32_t>(a);
    *next = f == kLstAppend      ? static_cast<int32_t>(appended)
            : f == kLstAppendAny ? static_cast<int32_t>(shifted)
                                 : state;
  }
};

// The step of the model with runtime id `model` (unknown ids take the
// register's step; the launchers refuse them first).
__device__ __forceinline__ void model_step(int model, int32_t state,
                                           int32_t f, int32_t a, int32_t b,
                                           int32_t* next, bool* legal) {
  switch (model) {
    case kModelCounter:
      Model<kModelCounter>::step(state, f, a, b, next, legal);
      break;
    case kModelQueue:
      Model<kModelQueue>::step(state, f, a, b, next, legal);
      break;
    case kModelSet:
      Model<kModelSet>::step(state, f, a, b, next, legal);
      break;
    case kModelListAppend:
      Model<kModelListAppend>::step(state, f, a, b, next, legal);
      break;
    case kModelCasRegister:
    default:
      Model<kModelCasRegister>::step(state, f, a, b, next, legal);
  }
}

}  // namespace
