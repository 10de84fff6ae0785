// The failure record of the C entry points (see errors.cuh) and the entry
// point that reads it.

#include <cuda.h>
#include <stdarg.h>
#include <stdio.h>

#include "errors.cuh"

namespace adyolo {

thread_local Failure last_failure = {nullptr, {0}, 0, 0};
thread_local const char* current_entry = nullptr;

namespace {

int record(int code, int driver, const char* fmt, va_list ap) {
    last_failure.entry = current_entry;
    vsnprintf(last_failure.site, sizeof(last_failure.site), fmt, ap);
    last_failure.code = code;
    last_failure.driver = driver;
    return code;
}

}  // namespace

int fail(int code, const char* fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    record(code, 0, fmt, ap);
    va_end(ap);
    // A runtime call that returns an error also leaves it as the thread's
    // last error.  `enter` found none pending and every runtime call since
    // is checked, so what is pending now is this site's, reported here.
    cudaGetLastError();
    return code;
}

int fail_driver(int code, const char* fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    record(code, 1, fmt, ap);
    va_end(ap);
    return code;
}

int enter(const char* entry) {
    current_entry = entry;
    last_failure = {nullptr, {0}, 0, 0};
    const cudaError_t e = cudaGetLastError();
    return e == cudaSuccess
               ? 0
               : fail((int)e, "an error was pending on this thread before the entry point ran");
}

int check_launch(const char* kernel) {
    const cudaError_t e = cudaGetLastError();
    return e == cudaSuccess ? 0 : fail((int)e, "launch of %s", kernel);
}

}  // namespace adyolo

// The name of a CUresult, through the CUDA driver's cuGetErrorName looked up
// at run time (the library links no -lcuda).
static const char* driver_error_name(int code) {
    typedef CUresult (*NameFn)(CUresult, const char**);
    static NameFn name_fn = nullptr;
    if (name_fn == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPointByVersion("cuGetErrorName", &fn, 12000, cudaEnableDefault,
                                             &found) != cudaSuccess ||
            found != cudaDriverEntryPointSuccess || fn == nullptr) {
            cudaGetLastError();  // this lookup's own failure, reported as the name below
            return "CUresult (cuGetErrorName not found)";
        }
        name_fn = reinterpret_cast<NameFn>(fn);
    }
    const char* name = nullptr;
    return name_fn((CUresult)code, &name) == CUDA_SUCCESS && name ? name : "unknown CUresult";
}

// The last failure of an entry point on the calling thread: 1 and its
// entry point, site, code and the code's name (cudaGetErrorName, or the
// CUDA driver's name of a CUresult), or 0 when the thread's last entry point
// call recorded none.
extern "C" int adyolo_last_error(const char** entry, const char** site, int* code,
                                 const char** name) {
    const adyolo::Failure& f = adyolo::last_failure;
    if (f.code == 0) return 0;
    *entry = f.entry ? f.entry : "(no entry point)";
    *site = f.site;
    *code = f.code;
    *name = f.driver ? driver_error_name(f.code) : cudaGetErrorName((cudaError_t)f.code);
    return 1;
}
