// Size-class pool allocator for the host runtime.
//
// Host-side counterpart of the reference's pool allocator
// (src/libponyrt/mem/pool.{c,h}): size classes from 2^5 to 2^20 bytes,
// thread-local free lists with a mutex-protected global recycling tier.
// Only *host-side* runtime objects live here (ASIO events, queue nodes,
// staged messages); device memory is managed by the device framework's
// allocator, so the pagemap/virtual-alloc layers of the reference have
// no equivalent and are deliberately absent.
#pragma once

#include <cstddef>
#include <cstdint>

extern "C" {

// Round `size` up to its pool class and allocate (malloc-backed).
void* ponyx_pool_alloc(size_t size);
// Return a block allocated with ponyx_pool_alloc(size).
void ponyx_pool_free(size_t size, void* p);

// Telemetry (process-wide, approximate under concurrency).
uint64_t ponyx_pool_allocated();  // live blocks
uint64_t ponyx_pool_recycled();   // blocks parked on free lists

// Index of the size class serving `size` (for tests).
int ponyx_pool_index(size_t size);
}
