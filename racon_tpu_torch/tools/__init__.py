"""Operator tools over what the serve layer leaves behind, each run as
`python -m racon_tpu_torch.tools.<name>` and taking flags only:

    obsreport     a journal's job timelines beside the flight dumps, and
                  the journal checks (`--check`)
    tracereport   a merged trace's critical path split into stages (plan,
                  requeue, hold, wait, queue, device, host, gather, net,
                  merge), and its self-checks (`--check`)
    servetop      a live console over servers and routers: the fleet
                  line, a row a replica, tenants, the winner table, the
                  window cache, the audit and the autoscaler
    faultcheck    the fault grid: injected faults at each pipeline stage
                  in every column (depths, scheduler, tracer, fused
                  engine, a server, two lanes), held to the port's
                  contract (a raise typed, a hang waited out), then the
                  audit, router, range, fragment, trace and preempt
                  sections over replica processes killed with `kill -9`
    servebench    the serve benchmark: a warm server's jobs against cold
                  one-shot CLI processes, and the fleet, router, ramp,
                  audit, rounds, fragment, flood and open-loop modes,
                  with a JSON artifact (`--json`)
"""
