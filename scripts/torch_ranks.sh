# Sourced by the port's multi-process launch scripts (bash):
#
#   run_ranks COUNT FIRST_ID -- command ... @PROCESS_ID@ ...
#
# starts COUNT copies of the command at once, the i-th with @PROCESS_ID@
# replaced by FIRST_ID + i, and waits for them.  As soon as one fails, the
# others are stopped (they would wait for it in their next collective) and
# run_ranks returns 1; it returns 0 when every one succeeds.
run_ranks() {
    local count=$1 first=$2 i status=0
    local pids=()
    shift 3
    for ((i = 0; i < count; i++)); do
        "${@//@PROCESS_ID@/$((first + i))}" &
        pids+=($!)
    done
    for ((i = 0; i < count; i++)); do
        if ! wait -n; then
            status=1
            kill "${pids[@]}" 2>/dev/null || true
        fi
    done
    return $status
}
