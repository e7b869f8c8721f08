"""wire_pin_ms (result wire, knn/topk.py result_wire, csrc/result_wire.cu):
the host's ms a job taking and freeing page-locked memory, averaged over
the window's jobs: 1000 (pin_s + unpin_s) of knn_ivf.last, the seconds in
the program's span fedrann.wire.pin during the call (the result's block
and the rescore bounds' blocks) and in fedrann.wire.unpin since the
previous recorded call (here the harness's release of the read set's
previous result). None where the record lacks them."""


def read(ctx):
    if ctx.route != "ivf":
        return None
    ms = [1000.0 * (s["pin_s"] + s["unpin_s"]) for s in ctx.ivf
          if "pin_s" in s and "unpin_s" in s]
    return sum(ms) / len(ms) if ms else None
