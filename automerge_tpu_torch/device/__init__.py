"""Device layer of the PyTorch port: the general engine's fused apply
(:mod:`.general`), field resolution (:mod:`.merge`), RGA ordering
(:mod:`.sequence`) and the edit-stream kernel (:mod:`.cuda_view`)."""
