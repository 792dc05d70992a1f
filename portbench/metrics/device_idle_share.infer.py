"""The device's idle share of a prediction: 1 - the device's busy time an
image (the union of its intervals in the device-only profile) over the
untraced predictions' mean time in the same run (host clock), in %. The
profile itself slows the host, so its own window reads idler; the
result line's busy_s and window_s are that traced window's."""


def read(traced):
    busy = traced["trace"].busy_s() / traced["items"]
    if not busy or not traced["untraced_items"]:
        return None
    return 100.0 * (1.0 - busy * traced["untraced_items"]
                    / traced["untraced_s"])
