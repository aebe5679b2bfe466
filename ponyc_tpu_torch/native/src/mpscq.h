// Intrusive Vyukov MPSC queue with a message-count gauge.
//
// Host-side counterpart of the reference's actor mailbox queue
// (src/libponyrt/actor/messageq.{c,h}): many producers (ASIO loop,
// application threads) and one consumer (the host driver draining at
// step boundaries). Here it stages *host-bound* messages only — the
// device-side mailboxes are the dense ring-buffer table in HBM
// (ponyc_tpu_torch/runtime/state.py); this queue replaces the
// ASIO-thread → scheduler-thread hop of the reference
// (asio/event.c pony_asio_event_send → mailbox push).
//
// Messages are flat records of int32 words, pool-allocated:
//   [0] target actor id   [1] behaviour gid   [2..] payload words
#pragma once

#include <cstdint>

extern "C" {

typedef struct ponyx_mpscq ponyx_mpscq_t;

ponyx_mpscq_t* ponyx_mpscq_create();
void ponyx_mpscq_destroy(ponyx_mpscq_t* q);

// Push a message of `nwords` int32 words (copied). Thread-safe.
void ponyx_mpscq_push(ponyx_mpscq_t* q, const int32_t* words, int32_t nwords);

// Pop into `out` (capacity `cap` words); returns the message's word count,
// 0 if empty, or -needed if `cap` was too small (message stays queued).
// Single consumer only.
int32_t ponyx_mpscq_pop(ponyx_mpscq_t* q, int32_t* out, int32_t cap);

// Approximate queue depth (≙ the fork's messageq num_messages counter,
// used for load balancing / analysis).
int64_t ponyx_mpscq_count(ponyx_mpscq_t* q);
}
