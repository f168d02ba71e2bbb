"""Distribution layer (port of ``vrt.dist``): process groups and meshes,
ray data parallelism, and slab-sharded (model-parallel) volumes with halo
exchange, over ``torch.distributed``.

- ``vrt_torch.dist.mesh``: ``torch.distributed`` bring-up, the
  ('data', 'model') ``DeviceMesh``, and the collectives the layer uses
  (all-gather, sum all-reduce, the loss's sum, the neighbour send/recv
  pair), differentiable as ``vrt``'s transposes are,
- ``vrt_torch.dist.sharding``: the ray-sharded frame
  (``render_image_sharded``) and the data-parallel fit
  (``make_loss_and_grad_dp``, ``make_fit_step_dp``),
- ``vrt_torch.dist.brick``: a volume split into x-slabs with 2-voxel halos,
  the slab march (K7 on the card, ``march_volume_slab``), the closest-hit
  combine, the differentiable halo refresh, the slab resolve,
- ``vrt_torch.dist.slab_render``: the render pipeline over a slab-sharded
  volume (``SlabTracer``, ``GatherSlabTracer``, ``render_slab_image``) and
  its fit steps (``make_slab_fit_step``, ``make_slab_fit_step_crossed``).

Where ``vrt`` runs one SPMD program under ``shard_map``, the port runs one
process per rank; each holds its own slab and ray slice, and takes its own
backward, the collectives carrying the cotangents between the ranks.
``vrt_torch.apps.scaling`` times the slab fit step at 1, 2, 4, ... ranks.
"""
