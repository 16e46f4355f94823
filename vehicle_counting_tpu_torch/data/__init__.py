from vehicle_counting_tpu_torch.data.video import VideoReader, VideoWriter, list_videos
