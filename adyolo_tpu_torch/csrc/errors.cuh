// Failure reports of the C entry points (csrc/attention.cu, csrc/stft.cu).
//
// Many sites of a launcher can return the same CUDA error: an argument
// check, a tensor-map encode, a shared-memory opt-in, a launch.  Each
// site records where it failed with `fail`, as one formatted line beside
// the entry point's name and the error code, in a record kept per host
// thread (an entry point's caller reads it on the thread that called);
// `adyolo_last_error` (csrc/errors.cu) hands it to the wrapper, which
// raises with it.  `enter` starts an entry point: it clears the record and
// refuses to run when an error is already pending on the thread in this
// library's CUDA runtime, so that a launch's own `cudaGetLastError` can
// only ever report that launch.
#pragma once

#include <cuda_runtime.h>

namespace adyolo {

struct Failure {
    const char* entry;  // the C entry point
    char site[224];     // what failed, with the values that made it fail
    int code;           // cudaError_t, or a CUresult where `driver`
    int driver;
};

extern thread_local Failure last_failure;
extern thread_local const char* current_entry;

// Records a failure of the current entry point at the site `fmt`
// (printf-style) and returns `code`, which must not be 0.
int fail(int code, const char* fmt, ...);

// The same for a CUDA driver call's CUresult.
int fail_driver(int code, const char* fmt, ...);

// Starts entry point `entry`; 0, or the error pending on the thread.
int enter(const char* entry);

// cudaGetLastError() after launching `kernel`: 0, or that error, recorded.
int check_launch(const char* kernel);

}  // namespace adyolo
